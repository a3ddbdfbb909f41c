// Segmented aggregation: per slot, count, sum, min and max of int32 values.
//
// Replaces the TPU kernel `repro/kernels/agg/agg.py` (`seg_agg_pallas`,
// body `_seg_agg_kernel`, agg.py:81-114): group-by's reduce step.  Tuple i
// adds val[i] to slot gid[i]; a gid outside [0, S) contributes nothing.
// Empty slots report (0, 0, INT32_MAX, INT32_MIN).  The sum is either one
// wrapping int32 channel (wrap32) or the wide layout of agg.py: `chunks`
// channels of per-slot sums of the value's uint32 bit chunks of width
// `chunk_bits`, then one channel counting negative values, all int32 and
// row-major (channel k of slot g at sum[k * S + g]).  The chunk width is
// chosen by the caller from n (`wide_chunk_bits`), so no channel can
// overflow int32.
//
// The TPU kernel adds a (tile, S) one-hot expansion into VMEM-resident
// outputs.  That does not carry over: on the group-by path S is the owned
// tuple count, up to 2^24.  Instead:
//   1. an init kernel writes the neutral elements into all S slots;
//   2. each warp takes 32 consecutive tuples, groups the lanes with equal
//      gid with __match_any_sync, and reduces each group with
//      __reduce_add_sync (count, chunk channels, negatives) and
//      __reduce_min_sync / __reduce_max_sync;
//   3. the group's lowest lane applies the totals to global memory with
//      atomicAdd / atomicMin / atomicMax (an add of 0 is skipped).
// On the path gid is sorted (dense slot ids from sorted keys), so a warp
// mostly holds one or two groups and issues one set of atomics; unsorted
// gids stay right, only slower.  Integer atomics commute, so the result is
// deterministic; atomicAdd on int32 wraps mod 2^32, exactly like the wrap32
// accumulator.
//
// Bound: bytes.  The tuples are read once (8 n bytes) and the outputs
// written once (4 (3 + sum_rows) S bytes); the init pass and the atomics'
// read-modify-writes are above that bound.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void init_kernel(int32_t* __restrict__ cnt,
                            int32_t* __restrict__ sum,
                            int32_t* __restrict__ mn,
                            int32_t* __restrict__ mx, int slots,
                            int sum_rows) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < slots; i += stride) {
    cnt[i] = 0;
    mn[i] = INT_MAX;
    mx[i] = INT_MIN;
    for (int r = 0; r < sum_rows; ++r) {
      sum[r * static_cast<long long>(slots) + i] = 0;
    }
  }
}

// One valid lane's share of steps 2-3.  `active` holds the warp's valid
// lanes; every one of them calls this function.
template <bool kWrap32>
__device__ __forceinline__ void agg_group(
    int g, int v, unsigned active, int lane, int32_t* __restrict__ cnt,
    int32_t* __restrict__ sum, int32_t* __restrict__ mn,
    int32_t* __restrict__ mx, int slots, int chunk_bits, int chunks,
    uint32_t chunk_mask) {
  // `same` partitions the valid lanes; each group reduces with its own
  // mask, as cooperative groups' labeled_partition does.
  const unsigned same = __match_any_sync(active, g);
  const bool leader = lane == __ffs(same) - 1;
  const int lo = __reduce_min_sync(same, v);
  const int hi = __reduce_max_sync(same, v);
  if (kWrap32) {
    const unsigned s = __reduce_add_sync(same, static_cast<unsigned>(v));
    if (leader && s) atomicAdd(&sum[g], static_cast<int>(s));
  } else {
    const uint32_t u = static_cast<uint32_t>(v);
    for (int k = 0; k < chunks; ++k) {
      const unsigned s =
          __reduce_add_sync(same, (u >> (chunk_bits * k)) & chunk_mask);
      if (leader && s) {
        atomicAdd(&sum[k * static_cast<long long>(slots) + g],
                  static_cast<int>(s));
      }
    }
    const unsigned neg = __reduce_add_sync(same, v < 0 ? 1u : 0u);
    if (leader && neg) {
      atomicAdd(&sum[chunks * static_cast<long long>(slots) + g],
                static_cast<int>(neg));
    }
  }
  if (leader) {
    atomicAdd(&cnt[g], __popc(same));
    atomicMin(&mn[g], lo);
    atomicMax(&mx[g], hi);
  }
}

template <bool kWrap32>
__global__ void seg_agg_kernel(const int32_t* __restrict__ gid,
                               const int32_t* __restrict__ val,
                               int32_t* __restrict__ cnt,
                               int32_t* __restrict__ sum,
                               int32_t* __restrict__ mn,
                               int32_t* __restrict__ mx, long long n,
                               int slots, int chunk_bits, int chunks) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // Every lane of a warp runs the same number of iterations, so the warp
  // primitives below always see the whole warp arrive.
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          (threadIdx.x & ~31);
  const uint32_t chunk_mask = (1u << chunk_bits) - 1u;
  for (long long base = first; base < n; base += stride) {
    const long long i = base + lane;
    int g = -1;
    int v = 0;
    if (i < n) {
      g = gid[i];
      v = val[i];
    }
    const bool valid = g >= 0 && g < slots;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, valid);
    if (valid) {
      agg_group<kWrap32>(g, v, active, lane, cnt, sum, mn, mx, slots,
                         chunk_bits, chunks, chunk_mask);
    }
  }
}

int num_sms() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

int blocks_for(long long items) {
  const long long want = (items + THREADS - 1) / THREADS;
  const long long cap = 16LL * num_sms();
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// gid, val: (n,) int32.  cnt, mn, mx: (slots,) int32 out; sum: (sum_rows,
// slots) int32 out, sum_rows = 1 under wrap32, else chunks + 1 with
// chunks = ceil(32 / chunk_bits).  Returns the cudaError_t of the launch.
extern "C" int seg_agg(const int32_t* gid, const int32_t* val, int32_t* cnt,
                       int32_t* sum, int32_t* mn, int32_t* mx, long long n,
                       int slots, int wrap32, int chunk_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = wrap32 ? 0 : (32 + chunk_bits - 1) / chunk_bits;
  const int sum_rows = wrap32 ? 1 : chunks + 1;
  if (slots > 0) {
    init_kernel<<<blocks_for(slots), THREADS, 0, s>>>(cnt, sum, mn, mx, slots,
                                                      sum_rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n == 0 || slots == 0) return static_cast<int>(cudaGetLastError());
  if (wrap32) {
    seg_agg_kernel<true><<<blocks_for(n), THREADS, 0, s>>>(
        gid, val, cnt, sum, mn, mx, n, slots, 8, 0);
  } else {
    seg_agg_kernel<false><<<blocks_for(n), THREADS, 0, s>>>(
        gid, val, cnt, sum, mn, mx, n, slots, chunk_bits, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
