"""Kernel byte functions against PERF.md's kernel table, and the launch
model of a PHJ query."""
from collections import Counter

import pytest

from bench import roofline as rl

N = 1 << 24


@pytest.mark.parametrize("nbytes, table_ms", [
    (rl.bytes_a(N, 7), 0.040065),          # first pass, 7 bits
    (rl.bytes_b(N, 1 << 7), 0.100162),
    (rl.bytes_d(N), 0.040065),
    (rl.bytes_e(N, 1 << 13), 0.020042),    # P = 2^13
])
def test_bounds_reproduce_the_kernel_table(nbytes, table_ms):
    assert abs(rl.bound_s(nbytes) * 1e3 - table_ms) < 1e-6


@pytest.mark.parametrize("name, letter", [
    ("void (anonymous namespace)::fused_kernel<1, true>(int const*, int*, "
     "int*, long long, int, unsigned int, int)", "A"),
    ("(anonymous namespace)::scatter_shared(int const*, int const*, int "
     "const*, int const*, int*, int*, long long, int, long long)", "B"),
    ("(anonymous namespace)::tile_scan_warps(int*, int const*, long long)",
     "B"),
    ("(anonymous namespace)::hash_kernel(int const*, int*, long long, "
     "unsigned int)", "D"),
    ("void (anonymous namespace)::hist_kernel<true>(int const*, int*, long "
     "long, long long, int)", "E"),
    ("void (anonymous namespace)::seg_agg_kernel<false>(int const*)", "C"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<int>, std::array<char*, 3ul> >(int)",
     None),
    ("Memcpy DtoH (Device -> Pageable)", None),
    ("void at_cuda_detail::cub::DeviceScanKernel<int>(int)", None),
])
def test_kernel_names_map_to_letters(name, letter):
    assert rl.kernel_letter(name) == letter


def _count(launches):
    return dict(Counter(k for k, _ in launches))


def test_phj_launches_cold_and_from_cache():
    cold = rl.phj_query_launches(N, N, (7, 6), partition_ratio=0.0,
                                 join_ratio=0.0, build_layout_hit=False,
                                 probe_layout_hit=False)
    assert _count(cold) == {"A": 4, "B": 4, "D": 6, "E": 2}
    warm = rl.phj_query_launches(N, N, (7, 6), partition_ratio=0.0,
                                 join_ratio=0.0, build_layout_hit=True,
                                 probe_layout_hit=True)
    assert _count(warm) == {"D": 4}
    assert sum(b for _, b in warm) == 4 * 8 * N


def test_phj_launches_host_share_of_partitioning():
    one = rl.phj_query_launches(N, N, (13,), partition_ratio=0.25,
                                join_ratio=0.0, build_layout_hit=False,
                                probe_layout_hit=True)
    g = N - N // 4
    assert one[:4] == [("A", rl.bytes_a(g, 13)),
                       ("B", rl.bytes_b(g, 1 << 13)),
                       ("D", rl.bytes_d(g)), ("E", rl.bytes_e(g, 1 << 13))]
    all_host = rl.phj_query_launches(N, N, (13,), partition_ratio=1.0,
                                     join_ratio=0.0, build_layout_hit=False,
                                     probe_layout_hit=False)
    assert _count(all_host) == {"D": 4}
    with pytest.raises(ValueError):
        rl.phj_query_launches(N, N, (13,), partition_ratio=0.0,
                              join_ratio=0.5, build_layout_hit=False,
                              probe_layout_hit=False)
