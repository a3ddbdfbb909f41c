"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's eight CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
sm_90a, one process per source, all at once) and holds each integer kernel
bit for bit against its plain PyTorch version at the main paths' shapes and
at ragged and wide ones: A (n1+n2), B (n3), C (segmented aggregation),
D (hash bucket) and E (radix histogram), with A, B and E also at digits of
17 and 18 bits (past the planner's 16), A at 1-3 bits on ragged and
unaligned keys, E on clustered pids (sorted runs with out-of-range pids
inside them, ragged, unaligned, up to 2^17 bins), and ``phj_join`` over
the pass schedules (17,) and (9, 9) at 2^20 against the join oracle.  Then it drives the port's
main paths, each with the launch counts set to 0 just before it and read
just after, and verifies each against a NumPy oracle:

* the join: ``phj_join`` at 2^24 x 2^24 uniform tuples (the paper's
  default size, §5.1) and ``CoProcessor.phj`` under GPU_ONLY and DD;
* the group-by: ``CoProcessor.groupby`` over 2^24 tuples with 2^18
  uniform group keys, GPU_ONLY unpartitioned and partitioned, and DD
  partitioned and separate at 2^22 (the C share on the host CPU);
* the partitioned probe join (kernel F): ``build_partitioned_table`` and
  ``probe`` over 2^24 unique x 2^24 uniform tuples at 13 radix bits;
* the co-processed SHJ: ``CoProcessor.shj`` GPU_ONLY at 2^24, CPU_ONLY,
  DD and PL in both table modes and DD discrete at 2^22,
  ``basic_unit_shj`` at 2^22, and the semi / anti / left-outer probes of
  ``probe_table_variant`` (GPU_ONLY at 2^24, DD at 2^22).

* the LM serving path: Zamba2-1.2B at full width and depth (38 layers,
  d_model 2048, bf16, random weights from seed 0) through
  ``ServeEngine.generate`` for 4 prompts x 2048 tokens + 32 new and
  2 x 1000 + 16, with 6 launches of kernel G (flash attention) and 32 of
  kernel H (SSD intra-chunk) per generate, all in the prefill; the decode
  logits held against ``forward_train`` (which runs G and H) within
  tests/test_archs.py's 0.06 relative limit.

* the join-query engine (phase 11): ``QueryPlanner.calibrated`` at
  n = 2^20 (and at its default n, for comparison) measures the host's and
  the card's unit costs and the host hand-off; ``JoinQueryService`` (C
  group on the host CPU, G group on the card, two workers, a 2 GiB cache)
  serves the 16-query ``mixed`` workload at base 2^22 (relations of
  2^21-2^23), the paper's default query three times (cold, then from the
  cache), a group-by of 2^24 tuples with 2^18 keys, a semi and an anti
  join at 2^22 and a 2^22 query under one injected kernel fault, every
  result against a NumPy oracle; the content fingerprint's pull and hash
  are timed at 2^22 and 2^24.

* the multi-join query pipeline (phase 12), through ``PipelineExecutor``
  over a ``JoinQueryService`` with phase 11's calibrated planner and two
  workers: ``examples/query_pipeline.py``'s star with the fact table at
  2^24 and three 2^21 dimensions (the chosen, textual and worst orders
  priced; run cold and warm under the fused hand-off and once under the
  host hand-off), the chain 2^24 -> 2^22 -> 2^20, five
  ``WorkloadGenerator(2^22).analytic()`` queries (all four edge-kind
  pairs, all five aggregates, group-by sinks on kernel C), a replay of six
  ``star()`` queries, and an estimator-hostile skewed star at 2^22 static
  and adaptive, each exact against its NumPy oracle, with zero hand-off
  and fingerprint bytes on every fused run; the SHA-1 of the base key
  columns and the exact match counts are timed inside the runs.  Then the
  paper's §3.3 mechanisms at 2^24: divergence grouping of a skewed
  probe's p2 key counts, the scan allocator, and ``run_map_series`` over
  ``partition_series(0)`` with the C group on the host and a ratio that
  moves, bit-equal to one-device ``run_series``.

* MoE serving (phase 13): granite_moe_3b at full width and depth (32
  layers, d_model 1536, 40 experts top-8, bf16, random weights from seed
  0) through ``ServeEngine.generate`` for both batches of the LM phase,
  once under ``moe_impl="dense"`` (G 32 a generate, E none) and once
  under ``"sorted"``, the paper's radix-partition dispatch (E 32 per
  prefill and per decode step), with the dropped (token, slot) pairs of
  every layer; in float32 at the drop-free capacity factor (E / k) the
  decode logits against ``forward_train`` and dense against sorted
  within 0.06; the MoE layer (dense against sorted, float32, 2e-5), E
  (bit-exact) and G on the prefill's own activations; and one
  full-width llama4_maverick_400b unit (``DE``, 2 of its 48 layers)
  under both engines.

* encoder-decoder serving (phase 14): whisper_large_v3 at full width and
  depth (32 encoder and 32 decoder layers, d_model 1280, 20 heads of 64,
  1500 stub frames drawn as the serve CLI draws them, bf16, random
  weights from seed 0) through ``ServeEngine.generate`` for 8 clips x 4
  prompt tokens + 32 new and 4 x 224 + 16: 96 G launches a generate, 32
  each in the encoder (non-causal over 1500 frames), the decoder's
  self-attention and its cross attention, all ``wgmma``, none in decode;
  the grown cache's ``ck`` / ``cv`` are the prefill's own tensors; decode
  within 0.06 of ``forward_train`` in bf16 and in float32 (2 x 224 + 16,
  G's ``cuda_cores``); G on the first encoder block's and the first cross
  attention's activations.

* training (phase 15): zamba2_1_2b at full width and depth (bf16, seed
  0, remat "full") through ``make_train_step``: six steps of
  ``SyntheticLM(32000, 4096, 4)``, five of 4 sequences as two
  microbatches of 2 x 4096 and one of 2 x 4096 in one microbatch, each
  with its time (clock stopped after ``synchronize``), tokens/s, loss,
  gradient norm, lr, G and H launches by variant (12 and 62 a
  microbatch, all ``wgmma``: each unit's blocks run again in its
  recompute, the tail's do not) and peak memory; step 0's loss against
  plain cross-entropy over ``forward_train``'s whole logits; one
  microbatch's loss and gradient through G and H (their autograd
  Functions, with plain backward) against the same through their plain
  versions alone, leaf by leaf, on two microbatches: in bfloat16, in
  float32 at the same weights, and bfloat16's own rounding (plain
  bfloat16 against plain float32) beside them; then the same through a
  G that loses one key tile past 2048, which must break the limits (the
  control that shows they can see such a fault); G's and H's plain
  backward timed alone at the training shapes; then, in a child process
  that sets ``CUBLAS_WORKSPACE_CONFIG`` (so the rest of the script keeps
  PyTorch's default cuBLAS workspace), at reduced(zamba2_1_2b) under
  ``torch.use_deterministic_algorithms``: 2 steps against 1, a
  checkpoint, a restore and 1 more, bit for bit, and
  ``launch.train.main`` run twice with the same flags, the second
  resuming from the first's checkpoint and ending on its loss.

Kernel F (partitioned probe) is held against its plain version first,
like A-E, on sorted and on permuted rows (K from 1 to 2^20) and on
``build_partitioned_table``'s rows of negative build keys, and again at
2^17 partitions after the probe join; G and H
against theirs within tests/test_kernels.py's tolerances over their
grids in float32 and bfloat16 (H's bfloat16 cases through its
tensor-core variant and through its CUDA-core variant, which serves
float32), and on one attention block's and one Mamba2 block's
activations from the Zamba2 prefill, whose 32 H launches the
tensor-core variant must all serve.  Then the script times each kernel at the main paths' shapes
beside its bound, its plain version and one PyTorch library call (or a
composite of them), with CUDA events around launches enqueued back to
back.  G (wgmma + TMA at head_dim 64 and 128) is timed at the Zamba2
shape, at a Qwen3-8B-shaped GQA shape and non-causal at whisper's
encoder and cross attention shapes against SDPA, with the variant that
served it; B (the shared-memory tile reorder) at both passes of the
join's (7, 6) schedule against a stable sort and two gathers; A (wide
loads, per-warp sub-histograms) there too against ``torch.bincount``;
H (wgmma + TMA) at the Zamba2 prefill shape, with its CUDA-core
variant's time beside it; E (wide loads, runs merged before the atomic)
on the uniform pids of the probe join's packing (the record's row) and on
the clustered pids of the final headers and on granite's router pids
(65,536 and 32 into 40 bins; beside it, under ``per_input``);
F (a TMA ring, a producer warp, six consumer groups) at the probe join's
layout.  E and F are also timed in a CUDA graph (``graph_ms``), the
device's time without the host's per-call work.

G's and H's rows of the ``kernels`` record add ``train`` (the kernel and
its plain backward timed at the training shapes) and every row's
``launches_by_path`` a ``train_step`` entry (one step of two
microbatches).

The second-to-last line is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises, and the
script exits non-zero without a result.  It also exits non-zero without a
CUDA device, or without the rest of the repository beside it.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch.kernels as rk  # noqa: E402
import repro_torch.ops  # noqa: E402,F401  (attaches CoProcessor.groupby)
from repro_torch.core import (PCIE_LINK, CoProcessor,  # noqa: E402
                              Relation, join_oracle, phj_join,
                              radix_partition_scheduled, radix_of,
                              resolve_schedule, uniform_relation,
                              unique_relation)
from repro_torch.core.coprocess import owned_slice  # noqa: E402
from repro_torch import engine as eng  # noqa: E402
from repro_torch.kernels._build import build_all  # noqa: E402
from repro_torch.kernels.agg import agg  # noqa: E402
from repro_torch.kernels.hash import hash as hsh  # noqa: E402
from repro_torch.kernels.partition_hist import (  # noqa: E402
    fused, partition_hist, reorder)
from repro_torch.kernels.partition_hist.ref import (  # noqa: E402
    clustered_pids)
from repro_torch.kernels.probe import ops as pops  # noqa: E402
from repro_torch.kernels.probe import probe as pprobe  # noqa: E402
from repro_torch.kernels.probe.ref import (  # noqa: E402
    probe_ref, random_layout)
from repro_torch.ops import groupby as gb  # noqa: E402
from repro_torch.ops import join_variants as jv  # noqa: E402
import repro_torch.core.partition as cpart  # noqa: E402
import repro_torch.layers.attention as lattn  # noqa: E402
import repro_torch.layers.moe as lmoe  # noqa: E402
import repro_torch.layers.ssd as lssd  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import ShapeSpec, get_config, reduced  # noqa: E402
from repro_torch.core.tree import (flatten_with_paths,  # noqa: E402
                                   param_tree, tree_leaves)
from repro_torch.data.pipeline import SyntheticLM, make_batch  # noqa: E402
from repro_torch.kernels.flash_attn import ops as gops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.ssd import ops as hops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.step import (loss_and_grads,  # noqa: E402
                                    make_train_step)
from repro_torch.kernels.flash_attn import flash_attn as fa  # noqa: E402
from repro_torch.kernels.ssd import ssd as kssd  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.params import torch_dtype  # noqa: E402
from repro_torch.obs.timing import cuda_ms, graph_ms  # noqa: E402
from repro_torch.serve.engine import (ServeEngine,  # noqa: E402
                                      grow_cache, make_decode_step,
                                      make_prefill_step)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
N_MAIN = 1 << 24            # paper §5.1 default relation size
N_DD = 1 << 22
GRID_NS = (N_MAIN, 1_000_003, 4096)
GRID_BITS = (1, 6, 7, 13, 16)
GRID_SHIFTS = (0, 7)
GRID_BUCKETS = (1, 1 << 7, 1 << 13, 1 << 31)
GRID_PARTS = (2, 1 << 7, 1 << 13, 1 << 16)
# Digits wider than 16 bits (a pass schedule the reference takes past the
# planner's 16), narrow digits and ragged or unaligned key vectors.
N_WIDE = 1 << 20
WIDE_BITS = (17, 18)
NARROW_BITS = (1, 2, 3)
WIDE_SCHEDULES = ((17,), (9, 9))
WIDE_PROBE_BITS = 17
JOIN_KERNELS = ("partition_hist_fused", "radix_scatter", "hash_bucket",
                "radix_hist")
KERNELS = {
    "partition_hist_fused": {
        "source": "src/repro_torch/csrc/partition_hist_fused.cu",
        "replaces": "src/repro/kernels/partition_hist/fused.py:57",
        "bytes_per_tuple": 8},
    "radix_scatter": {
        "source": "src/repro_torch/csrc/radix_scatter.cu",
        "replaces": "src/repro/kernels/partition_hist/reorder.py:67",
        "bytes_per_tuple": 20},
    "seg_agg": {
        "source": "src/repro_torch/csrc/seg_agg.cu",
        "replaces": "src/repro/kernels/agg/agg.py:120"},
    "hash_bucket": {
        "source": "src/repro_torch/csrc/hash_bucket.cu",
        "replaces": "src/repro/kernels/hash/hash.py:31"},
    "radix_hist": {
        "source": "src/repro_torch/csrc/radix_hist.cu",
        "replaces": "src/repro/kernels/partition_hist/partition_hist.py:32"},
    "partitioned_probe": {
        "source": "src/repro_torch/csrc/partitioned_probe.cu",
        "replaces": "src/repro/kernels/probe/probe.py:54"},
    "flash_attn": {
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/flash_attn.py:65"},
    "ssd_intra_chunk": {
        "source": "src/repro_torch/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:40"},
}
LM_ARCH = "zamba2_1_2b"     # the one config whose serving runs G and H
# (batch, prompt, new tokens) of the two served batches: multiples of 128
# and 256, then a ragged prompt (G's tail and ssd_chunked's padding).
LM_BATCHES = ((4, 2048, 32), (2, 1000, 16))
LM_REL_LIMIT = 0.06         # tests/test_archs.py:83
# Kernel G's grid (B, Sq, Sk, H, KV, D, causal): tests/test_kernels.py:92-97,
# Zamba2's prefill, a Qwen3-8B-shaped GQA case, D = 96, a ragged length,
# the MoE configs' GQA ratios: granite 24 / 8 heads of 64, llama4 40 /
# 8 of 128, whisper_large_v3's 20 / 20 heads of 64 non-causal at its
# 1500 encoder frames (the encoder; cross attention of 224, 4 and 1
# queries) and causal at a 4-token prompt (the decoder's own prefill),
# and Zamba2's training microbatch (2 x 4096: key tiles past 2048).
GRID_G = ((2, 256, 256, 4, 2, 64, True), (1, 128, 384, 8, 8, 128, False),
          (2, 256, 256, 4, 4, 32, True), (1, 256, 256, 8, 2, 64, True),
          (4, 2048, 2048, 32, 32, 64, True), (1, 2048, 2048, 32, 8, 128, True),
          (1, 1024, 1024, 32, 32, 96, True), (1, 1000, 1000, 8, 2, 64, True),
          (1, 256, 256, 24, 8, 64, True), (1, 256, 256, 40, 8, 128, True),
          (2, 1500, 1500, 20, 20, 64, False), (2, 224, 1500, 20, 20, 64, False),
          (8, 4, 1500, 20, 20, 64, False), (1, 1, 1500, 20, 20, 64, False),
          (8, 4, 4, 20, 20, 64, True), (1, 1500, 1500, 20, 20, 64, False),
          (2, 4096, 4096, 32, 32, 64, True))
# Kernel H's grid (B, NC, Q, H, P, N): tests/test_kernels.py:114-116,
# Zamba2's prefill, Mamba2-2.7B's state width and a ragged chunk.
GRID_H = ((2, 3, 64, 4, 32, 16), (1, 2, 128, 8, 64, 64),
          (1, 2, 128, 4, 64, 128), (4, 8, 256, 64, 64, 64),
          (1, 4, 256, 80, 64, 128), (2, 1, 37, 64, 64, 64))
TOL_G = {torch.float32: 3e-5, torch.bfloat16: 2e-2}   # test_kernels.py:109
# G's error beside the size of what it computes: RMS(got - want) over
# RMS(want), asserted besides TOL_G.  TOL_G's bfloat16 limit is a fixed
# 2e-2, more than whole outputs where attention averages many keys
# (whisper's 1500 frames give outputs of about 0.006, N(0, 1) inputs
# about 0.04); this one scales with them, so a key tile dropped, doubled
# or diluted with zeros shows: 28 zero keys among 1500 move near-uniform
# outputs by 1.8 %.  Rounding to bfloat16 (2^-9 relative) bounds what a
# right kernel reaches.
REL_G = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
ENCDEC_F32_REL_LIMIT = 1e-4  # decode vs forward_train, whisper in float32
TOL_H = {torch.float32: 2e-4, torch.bfloat16: 3e-2}   # test_kernels.py:128
PROBE_BITS = 13             # the planner's (7, 6) schedule at 2^24
# (P, K, M) of kernel F's check, each on sorted and on permuted rows:
# P in {1, 16, 2^13} x K in {1, 8, 36, 37, 2304}, a row past the 48 KB
# default of shared memory, and one longer than shared memory holds at all
# (searched in device memory).  K = 37 and 1 take the one-block-per-row
# kernel (rows off 16 bytes), the others with K <= 2304 the TMA ring.
GRID_PROBE = ((1, 8, 8), (16, 8, 300), (8192, 8, 128), (16, 1, 300),
              (64, 36, 129), (64, 37, 129), (1, 2304, 5000),
              (16, 2304, 2304), (8192, 2304, 2304), (16, 32768, 4096),
              (1, 1 << 20, 1 << 16))
# Kernel E's clustered check: sorted runs with out-of-range pids inside,
# ragged n, P up to 2^17, aligned and 4 bytes past (phase 6 checks both
# of its inputs at 2^24 too).
E_CLUSTER_NS = (1, 3, 4099, N_WIDE + 3)
E_CLUSTER_PARTS = (1, 2, 1 << 13, 1 << 14, 1 << 17)
# Phase 11, the join-query engine: the mixed workload's base size (its
# relations are 2^21-2^23), the calibration size (a step on the card
# costs more than a launch there) and the fingerprint's timed sizes.
ENGINE_BASE = 1 << 22
ENGINE_QUERIES = 16
ENGINE_CAL_N = 1 << 20
FINGERPRINT_NS = (N_DD, N_MAIN)
ENGINE_KERNELS = ("partition_hist_fused", "radix_scatter", "hash_bucket",
                  "radix_hist", "seg_agg")
# Phase 13, MoE serving: granite at full width and depth, served with the
# two batches of LM_BATCHES under each dispatch engine; one full-width
# unit (DE, 2 layers) of llama4, whose 48 layers do not fit one card.
MOE_ARCH = "granite_moe_3b"
MOE_UNIT_ARCH = "llama4_maverick_400b"
MOE_UNIT_BATCH = (1, 512, 8)
MOE_ENGINES = ("dense", "sorted")
MOE_LAYER_REL = 2e-5        # tests/test_layers.py: dense against sorted
MOE_AUX_REL = 1e-5
# Phase 14, encoder-decoder serving: whisper at full width and depth, both
# runs inside its 448-token decoder context: transcription from the
# start-of-transcript tokens (8 clips x 4 prompt tokens + 32 new), and
# long-form transcription conditioned on the previous window's text (4 x
# 224 + 16: Whisper caps that prompt near half its context); float32 at 2
# clips of the long-form shape.
ENCDEC_ARCH = "whisper_large_v3"
ENCDEC_BATCHES = ((8, 4, 32), (4, 224, 16))
ENCDEC_F32_BATCH = (2, 224, 16)
# Phase 15, training: Zamba2-1.2B at full width and depth (the config
# whose forward runs G and H), 4096 tokens a sequence (the train_4k
# cell's length, configs/base.py), 4 sequences a step as two microbatches
# of 2, then a last step of 2 sequences in one microbatch; AdamW as
# launch/train.py builds it (lr 1e-3, warmup min(20, steps // 5)).
TRAIN_ARCH = "zamba2_1_2b"
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
TRAIN_ACCUM = 2
TRAIN_STEPS = 6
TRAIN_LR = 1e-3
# The full-width gradient through G and H against the one through their
# plain versions (forward and backward), on two microbatches, with
# RMS(diff) / RMS(plain) per leaf and over the whole gradient.  In
# bfloat16: the loss, the whole gradient, the median leaf and the worst
# of the six attention blocks' q/k/v/o projections; in float32 at the
# same weights: the loss and every leaf.  Control for bfloat16's
# rounding: the distance from the plain float32 gradient through the
# kernels in bfloat16 over the same through the plain versions in
# bfloat16, for the whole gradient and for the worst leaf.  Readings on
# an H100 80GB HBM3 at 700 W (PERF.md): sound 9.7e-6, 1.03e-3,
# 1.04e-3, 0.0142, 0, 4.1e-5, 1.014, 1.167; G with one 64-key tile past
# 2048 lost 5.8e-4, 5.7e-3, 6.1e-3, 0.647, 2.8e-4, 0.65, 2.45, 4.10.
# Each limit sits between the two; the float32 leaf limit ten times the
# sound reading (the conv leaves of Mamba2 blocks: their gradient sums
# cancel, so plain bfloat16 alone moves them by up to 0.55).
TRAIN_LOSS_REL = 1e-4
TRAIN_WHOLE_REL = 3e-3
TRAIN_MEDIAN_LEAF_REL = 3e-3
TRAIN_ATTN_PROJ_REL = 1e-1
TRAIN_F32_LOSS_REL = 1e-6
TRAIN_F32_LEAF_REL = 4e-4
TRAIN_BF16_WHOLE_RATIO = 1.2
TRAIN_BF16_WORST_RATIO = 2.0
# The fault control: keys and values [2048, 2112) zeroed in G's kernel
# path, and the limits it must break.
TRAIN_FAULT_KEYS = (2048, 2112)
TRAIN_FAULT_BREAKS = {"loss", "whole", "median leaf", "attention projection",
                      "f32 loss", "f32 leaf", "whole ratio"}
# Step 0's loss against plain cross-entropy over ``forward_train``'s
# whole logits at the same weights (float32 over the same bf16 logits:
# only the order of the sums differs).
TRAIN_LOSS0_REL = 1e-4
# The resume check and the CLI at reduced(zamba2_1_2b), bit for bit
# under torch.use_deterministic_algorithms, in a child process started
# with this flag and CUBLAS_WORKSPACE_CONFIG set (cuBLAS reads it once,
# when it starts).
TRAIN_SMALL_SHAPE = (2, 128)
RESUME_FLAG = "--resume-check"


def log(*a):
    print(*a, flush=True)


T_START = time.perf_counter()


def log_phase(label: str) -> None:
    log(f"{label} (at {time.perf_counter() - T_START:.1f} s)")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def keys_for(n: int, dev, seed: int) -> torch.Tensor:
    """int32 keys over the whole range, with the negative pad sentinels."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
    keys[: min(n, 4)] = [-2, -3, -1, 2**31 - 1][: min(n, 4)]
    return torch.from_numpy(keys.astype(np.int32)).to(dev)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_kernels(dev) -> dict[str, int]:
    """Phases 2-3: kernels A and B against their plain versions, bit for
    bit, over every n x bits x shift of the grid.  Returns the largest
    absolute difference seen per kernel (0 when bit-exact)."""
    err = {name: 0 for name in KERNELS}
    for n in GRID_NS:
        keys = keys_for(n, dev, seed=n)
        rng = np.random.default_rng(n + 1)
        rid = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
        for bits in GRID_BITS:
            for shift in GRID_SHIFTS:
                pid, hist = fused.partition_hist_fused(keys, shift=shift,
                                                       bits=bits)
                ppid, phist = fused.partition_hist_fused_plain(
                    keys, shift=shift, bits=bits)
                ea = max(max_abs_diff(pid, ppid), max_abs_diff(hist, phist))
                starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
                orid, okey = reorder.radix_scatter(rid, keys, pid, starts,
                                                   num_parts=1 << bits)
                prid, pkey = reorder.radix_scatter_plain(rid, keys, ppid)
                eb = max(max_abs_diff(orid, prid), max_abs_diff(okey, pkey))
                torch.cuda.synchronize()
                log(f"  n={n} bits={bits} shift={shift}: A err={ea} "
                    f"B err={eb}")
                assert ea == 0 and eb == 0, (n, bits, shift, ea, eb)
                err["partition_hist_fused"] = max(
                    err["partition_hist_fused"], ea)
                err["radix_scatter"] = max(err["radix_scatter"], eb)
    return err


def check_wide_kernels(dev) -> dict[str, int]:
    """Phases 2-3, continued: A, B and E at digits of 17 and 18 bits
    (2^17 and 2^18 partitions: A's and E's global histograms, B's
    device-memory cursors) at n = 2^20, shifts 0 and 7; A at narrow digits
    (1-3 bits) on a ragged n and on keys that start 4 bytes past an
    aligned address (its scalar path); all bit for bit."""
    err = {"partition_hist_fused": 0, "radix_scatter": 0, "radix_hist": 0}
    keys = keys_for(N_WIDE, dev, seed=17)
    rid = torch.arange(N_WIDE, dtype=torch.int32, device=dev)
    for bits in WIDE_BITS:
        for shift in GRID_SHIFTS:
            pid, hist = fused.partition_hist_fused(keys, shift=shift,
                                                   bits=bits)
            ppid, phist = fused.partition_hist_fused_plain(keys, shift=shift,
                                                           bits=bits)
            ea = max(max_abs_diff(pid, ppid), max_abs_diff(hist, phist))
            ee = max_abs_diff(partition_hist.radix_hist(pid,
                                                        num_parts=1 << bits),
                              phist)
            starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
            got = reorder.radix_scatter(rid, keys, pid, starts,
                                        num_parts=1 << bits)
            want = reorder.radix_scatter_plain(rid, keys, ppid)
            eb = max(max_abs_diff(a, b) for a, b in zip(got, want))
            torch.cuda.synchronize()
            log(f"  n={N_WIDE} bits={bits} shift={shift}: A err={ea} B err={eb} "
                f"E err={ee} (B on {reorder.tile_len(1 << bits)}-tuple "
                "tiles, device memory)")
            assert ea == eb == ee == 0, (bits, shift, ea, eb, ee)
    for n in (N_WIDE + 3, 5):
        base = keys_for(n + 1, dev, seed=n)
        for bits in NARROW_BITS:
            for name, k in (("aligned", base[:n]), ("offset", base[1:])):
                got = fused.partition_hist_fused(k, shift=7, bits=bits)
                want = fused.partition_hist_fused_plain(k, shift=7, bits=bits)
                ea = max(max_abs_diff(a, b) for a, b in zip(got, want))
                torch.cuda.synchronize()
                assert ea == 0, ("narrow", n, bits, name, ea)
        log(f"  n={n} bits 1-3, aligned and offset keys: A err=0")
    return err


def run_wide_joins(dev) -> None:
    """Phases 2-3, continued: ``phj_join`` over pass schedules past 16
    bits, uniform(2^20, seed 1) x uniform(2^20, seed 2), against the
    join oracle."""
    build = uniform_relation(N_WIDE, seed=1, device=dev)
    probe = uniform_relation(N_WIDE, seed=2, device=dev)
    exp = uniform_oracle(N_WIDE)
    for sched in WIDE_SCHEDULES:
        rk.reset_launch_counts()
        res = phj_join(build, probe, schedule=sched,
                       max_out=2 * N_WIDE + len(exp))
        counts = rk.launch_counts()
        for name in ("partition_hist_fused", "radix_scatter", "radix_hist"):
            assert counts[name] > 0, (sched, name, counts)
        verify(res, exp, f"phj_join 2^20 x 2^20, schedule {sched}")


def check_group_kernels(dev) -> dict[str, int]:
    """Phases 2-3, continued: kernels C, D and E against their plain
    versions, bit for bit, over n x (S, wrap32, gid order) for C, n x B
    for D and n x P for E, with negative keys, gids -1 and >= S, and pids
    outside [0, P).  Returns the largest absolute difference per kernel."""
    err = {"seg_agg": 0, "hash_bucket": 0, "radix_hist": 0}
    for n in GRID_NS:
        rng = np.random.default_rng(n + 2)
        keys = keys_for(n, dev, seed=n + 3)
        val = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                               .astype(np.int32)).to(dev)
        for b in GRID_BUCKETS:
            e = max_abs_diff(hsh.hash_bucket(keys, num_buckets=b),
                             hsh.hash_bucket_plain(keys, num_buckets=b))
            err["hash_bucket"] = max(err["hash_bucket"], e)
            assert e == 0, ("hash_bucket", n, b, e)
        for p in GRID_PARTS:
            pid = torch.from_numpy(rng.integers(-2, p + 2, n)
                                   .astype(np.int32)).to(dev)
            e = max_abs_diff(partition_hist.radix_hist(pid, num_parts=p),
                             partition_hist.radix_hist_plain(pid,
                                                             num_parts=p))
            err["radix_hist"] = max(err["radix_hist"], e)
            assert e == 0, ("radix_hist", n, p, e)
        for slots in (1, 1000, n):
            unsorted = torch.from_numpy(rng.integers(-1, slots + 2, n)
                                        .astype(np.int32)).to(dev)
            for order, gid in (("unsorted", unsorted),
                               ("sorted", torch.sort(unsorted).values)):
                for wrap32 in (False, True):
                    got = agg.seg_agg(gid, val, num_slots=slots,
                                      wrap32=wrap32)
                    want = agg.seg_agg_plain(gid, val, num_slots=slots,
                                             wrap32=wrap32)
                    e = max(max_abs_diff(a, b) for a, b in zip(got, want))
                    torch.cuda.synchronize()
                    err["seg_agg"] = max(err["seg_agg"], e)
                    assert e == 0, ("seg_agg", n, slots, order, wrap32, e)
                    if not wrap32:
                        log(f"  n={n} S={slots} {order}: C err={e} "
                            f"(sum rows {got[1].shape[0]})")
        log(f"  n={n}: D err={err['hash_bucket']} E err={err['radix_hist']}")
    return err


@functools.lru_cache(maxsize=None)
def uniform_oracle(n: int) -> np.ndarray:
    """``join_oracle`` of uniform(n, seed 1) x uniform(n, seed 2), once per
    n: phases 4, 5 and 8 join the same relations."""
    return join_oracle(uniform_relation(n, seed=1, device="cpu"),
                       uniform_relation(n, seed=2, device="cpu"))


def phase_ms(t) -> dict:
    """A ``Timing``'s phase seconds as milliseconds, for the log."""
    return {k: round(v * 1e3, 3) for k, v in t.phase_s.items()}


def verify(res, exp: np.ndarray, what: str) -> None:
    """Count and sorted pairs equal to the oracle's ``exp``."""
    got = res.valid_pairs()
    assert int(res.count) == len(exp), (what, int(res.count), len(exp))
    assert got.shape == exp.shape and np.array_equal(got, exp), what
    log(f"  {what}: {len(exp)} matches, verified against the oracle")


def run_main_path(dev) -> dict:
    """Phase 4: phj_join at 2^24 x 2^24 with the planner's schedule."""
    build = uniform_relation(N_MAIN, seed=1, device=dev)
    probe = uniform_relation(N_MAIN, seed=2, device=dev)
    sched = resolve_schedule(N_MAIN)
    # max_out = 2n + matches, as examples/coprocess_join.py sizes it.
    exp = uniform_oracle(N_MAIN)
    max_out = 2 * N_MAIN + len(exp)
    log(f"  schedule {sched}, max_out {max_out}")
    phj_join(build, probe, max_out=max_out)          # warm-up
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = phj_join(build, probe, max_out=max_out)
    end.record()
    end.synchronize()
    counts = rk.launch_counts()
    wall_ms = start.elapsed_time(end)
    log(f"  phj_join wall {wall_ms:.3f} ms (CUDA events), launches {counts}")
    for name in JOIN_KERNELS:
        assert counts[name] > 0, f"main path never launched {name}"
    assert res.probe_rid.device.type == "cuda"
    verify(res, exp, "phj_join 2^24 x 2^24")
    return {"schedule": list(sched), "wall_ms": wall_ms, "launches": counts}


def run_coprocessor(dev) -> dict:
    """Phase 5: CoProcessor.phj, GPU_ONLY at 2^24 and DD at 2^22 (the C
    share runs the plain versions on the host CPU)."""
    cp = CoProcessor(c_device="cpu", g_device=dev)
    out = {}
    for scheme, n, pr, jr in (("GPU_ONLY", N_MAIN, 0.0, 0.0),
                              ("DD", N_DD, 0.25, 0.4)):
        build = uniform_relation(n, seed=1, device=dev)
        probe = uniform_relation(n, seed=2, device=dev)
        exp = uniform_oracle(n)
        rk.reset_launch_counts()
        res, t = cp.phj(build, probe, shj_bits=2, max_out=2 * n + len(exp),
                        partition_ratio=pr, join_ratio=jr)
        counts = rk.launch_counts()
        log(f"  {scheme} n={n}: phases {t.phase_s}, launches {counts}")
        for name in JOIN_KERNELS:
            assert counts[name] > 0, f"{scheme} never launched {name}"
        verify(res, exp, f"CoProcessor.phj {scheme}")
        out[scheme] = {"n": n, "phase_s": t.phase_s, "launches": counts}
    return out


def group_data(n: int, seed: int):
    """Group keys uniform in [0, n/64) and two value sets: uniform in
    [0, 100) and full-range int32 (exact wide sums), made with NumPy."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n // 64, n, dtype=np.int32)
    small = rng.integers(0, 100, n, dtype=np.int32)
    full = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return keys, {"small": small, "full": full}


def group_oracle(keys: np.ndarray, vals: np.ndarray):
    """Vectorized group-by oracle: sort + reduceat, exact int64 sums."""
    o = np.argsort(keys, kind="stable")
    sk, sv = keys[o], vals[o].astype(np.int64)
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    return (sk[starts], np.diff(np.r_[starts, sk.shape[0]]),
            np.add.reduceat(sv, starts), np.minimum.reduceat(sv, starts),
            np.maximum.reduceat(sv, starts))


def verify_groups(res, exp, what: str) -> None:
    got = res.sorted()
    assert res.num_groups == exp[0].shape[0], (what, res.num_groups)
    for name, g, e in zip(("keys", "counts", "sums", "mins", "maxs"),
                          (got.keys, got.counts, got.sums, got.mins,
                           got.maxs), exp):
        assert np.array_equal(g.astype(np.int64), e.astype(np.int64)), \
            (what, name)
    assert got.sums.dtype == np.int64


def agg_steps_ms(dev, rel: Relation, vals: torch.Tensor, sched) -> dict:
    """The GPU_ONLY partitioned group-by's agg phase, step by step, each
    step timed with CUDA events after a warm-up."""
    parts = radix_partition_scheduled(rel, schedule=sched).rel
    total_bits = sum(sched)
    steps = {}

    def timed(name, fn):
        steps[name] = cuda_ms(fn, reps=5, warmup=1)
        return fn()

    pid = timed("owner pids (D)",
                lambda: radix_of(parts.key, shift=0, bits=total_bits))
    sub, _ = timed("owned select", lambda: owned_slice(
        parts, pid, 0, 1 << total_bits, 1, gb.GROUP_PAD_KEY))
    v = timed("gather values", lambda: gb._gather_values(vals, sub.rid))
    order = timed("sort", lambda: torch.sort(
        sub.key ^ agg.INT32_MIN, stable=True).indices)
    skey = sub.key[order]

    def slot_ids():
        first = torch.ones(sub.size, dtype=torch.bool, device=dev)
        first[1:] = skey[1:] != skey[:-1]
        gid = (torch.cumsum(first, 0, dtype=torch.int32) - 1).to(
            torch.int32)
        ukeys = torch.full((sub.size,), gb.GROUP_PAD_KEY, dtype=torch.int32,
                           device=dev)
        ukeys[gid.to(torch.int64)] = skey
        return gid, ukeys

    gid, ukeys = timed("slot ids", slot_ids)
    out = timed("C (seg_agg)", lambda: agg.seg_agg(
        gid, v[order], num_slots=sub.size))
    timed("collect", lambda: gb._collect([(ukeys, *out, None)],
                                         wrap32=False))
    return steps


def run_groupby(dev) -> dict:
    """Phase 5b: the group-by main path, CoProcessor.groupby, GPU_ONLY
    unpartitioned and partitioned at 2^24 (after one warm-up call each),
    DD partitioned and separate at 2^22, each with both value sets,
    verified against the oracle."""
    cp = CoProcessor(c_device="cpu", g_device=dev)
    out = {}
    for n, runs in ((N_MAIN, (("GPU_ONLY", None, 0.0, 0.0),
                              ("GPU_ONLY_PART", resolve_schedule(N_MAIN),
                               0.0, 0.0))),
                    (N_DD, (("DD_PART", resolve_schedule(N_DD), 0.25, 0.4),
                            ("DD_SEPARATE", None, 0.25, 0.25)))):
        keys, value_sets = group_data(n, seed=n)
        rel = Relation(torch.arange(n, dtype=torch.int32, device=dev),
                       torch.from_numpy(keys).to(dev))
        if n == N_MAIN:
            # One untimed call per scheme first, as phase 4 warms up
            # phj_join: the first call pays the allocator's growth.
            warm = torch.from_numpy(value_sets["full"]).to(dev)
            for scheme, sched, pr, ar in runs:
                _, t = cp.groupby(rel, warm, schedule=sched,
                                  partition_ratio=pr, agg_ratio=ar)
                log(f"  warm-up {scheme}: phases {phase_ms(t)} ms")
        for vname, vals in value_sets.items():
            exp = group_oracle(keys, vals)
            tvals = torch.from_numpy(vals).to(dev)
            for scheme, sched, pr, ar in runs:
                torch.cuda.synchronize()
                rk.reset_launch_counts()
                res, t = cp.groupby(rel, tvals, schedule=sched,
                                    partition_ratio=pr, agg_ratio=ar)
                counts = rk.launch_counts()
                what = f"groupby {scheme} n={n} values={vname}"
                log(f"  {what}: schedule {sched}, phases "
                    f"{phase_ms(t)}"
                    f" ms, merge {t.merge_s * 1e3:.3f} ms, "
                    f"{res.num_groups} groups, launches {counts}")
                need = (("seg_agg",) if sched is None else
                        ("seg_agg",) + JOIN_KERNELS)
                for name in need:
                    assert counts[name] > 0, f"{what} never launched {name}"
                verify_groups(res, exp, what)
                out[f"{scheme}/{vname}"] = {
                    "n": n, "schedule": list(sched or ()),
                    "phase_ms": {k: v * 1e3 for k, v in t.phase_s.items()},
                    "launches": counts}
        if n == N_MAIN:
            steps = agg_steps_ms(dev, rel, torch.from_numpy(
                value_sets["full"]).to(dev), resolve_schedule(N_MAIN))
            log(f"  GPU_ONLY_PART agg-phase steps (ms, CUDA events): {steps}")
            out["agg_steps_ms"] = steps
    return out


def check_probe_kernel(dev) -> dict[str, int]:
    """Phases 2-3, continued: kernel F against ``probe_plain``, bit for
    bit, over ``GRID_PROBE``."""
    limit = pprobe.max_shared_keys()
    err = 0
    for p, k, m in GRID_PROBE:
        for order in ("sorted", "permuted"):
            tk, tr, pk = random_layout(p, k, m, seed=p + k, device=dev,
                                       sorted_rows=order == "sorted")
            got = pprobe.probe(tk, tr, pk)
            e = max_abs_diff(got, pprobe.probe_plain(tk, tr, pk))
            torch.cuda.synchronize()
            log(f"  P={p} K={k} M={m} {order} rows "
                f"({'shared' if k <= limit else 'device'} memory, "
                f"{int((got >= 0).sum())} hits): F err={e}")
            assert e == 0, ("partitioned_probe", p, k, m, order, e)
            err = max(err, e)
    assert GRID_PROBE[-1][1] > limit, ("no row past shared memory", limit)
    # build_partitioned_table's own rows, with negative build keys:
    # [non-negative ascending][negative ascending][INT_MAX pads].
    n = 1 << 16
    rng = np.random.default_rng(7)
    build = Relation(torch.arange(n, dtype=torch.int32, device=dev),
                     torch.from_numpy(rng.integers(-n, n, n)
                                      .astype(np.int32)).to(dev))
    probe = Relation(torch.arange(n, dtype=torch.int32, device=dev),
                     torch.from_numpy(rng.integers(-n // 2, 3 * n // 2, n)
                                      .astype(np.int32)).to(dev))
    tk, tr, qk, _ = pops.build_partitioned_table(build, probe, total_bits=7)
    e = max_abs_diff(pprobe.probe(tk, tr, qk), pprobe.probe_plain(tk, tr, qk))
    torch.cuda.synchronize()
    log(f"  build_partitioned_table, negative build keys, P=128 "
        f"K={tk.shape[1]} M={qk.shape[1]}: F err={e}")
    assert e == 0, ("partitioned_probe negative layout", e)
    return {"partitioned_probe": err}


def check_clustered_hist(dev) -> dict[str, int]:
    """Phases 2-3, continued: kernel E on clustered pids (``_headers``'s
    input) against ``radix_hist_plain``, bit for bit: runs that cross
    vector, warp and block edges with out-of-range pids inside them, over
    ragged n x P, aligned and 4 bytes past a 16-byte boundary."""
    err = 0
    for n in E_CLUSTER_NS:
        for p in E_CLUSTER_PARTS:
            base = clustered_pids(n + 1, p, seed=n + p, device=dev)
            for name, pid in (("aligned", base[:n]), ("offset", base[1:])):
                e = max_abs_diff(partition_hist.radix_hist(pid, num_parts=p),
                                 partition_hist.radix_hist_plain(
                                     pid, num_parts=p))
                torch.cuda.synchronize()
                assert e == 0, ("radix_hist clustered", n, p, name, e)
                err = max(err, e)
        log(f"  n={n} clustered, P in {E_CLUSTER_PARTS}, aligned and "
            f"offset: E err={err}")
    return {"radix_hist": err}


def check_wide_probe(dev, n: int = 1 << 16) -> dict[str, int]:
    """Phase 7, continued: the layout packing and kernel F at 2^17
    partitions (past the old 2^16 cap), unique(n) x uniform(n), the probe
    against its plain version bit for bit and the pairs against the join
    oracle."""
    build = unique_relation(n, seed=3, device=dev)
    probe = uniform_relation(n, seed=4, device=dev)
    rk.reset_launch_counts()
    layout = pops.build_partitioned_table(build, probe,
                                          total_bits=WIDE_PROBE_BITS)
    rid = pops.probe(*layout[:3])
    counts = rk.launch_counts()
    assert counts["partitioned_probe"] == 1 and counts["radix_hist"] == 2, \
        counts
    e = max_abs_diff(rid, pprobe.probe_plain(*layout[:3]))
    got = probe_pairs(layout[3], rid)
    exp = join_oracle(build, probe)
    assert e == 0 and got.shape == exp.shape and np.array_equal(got, exp), \
        ("wide partitioned probe", e)
    log(f"  P=2^{WIDE_PROBE_BITS} K={layout[0].shape[1]} "
        f"M={layout[2].shape[1]}, {n} x {n}: F err={e}, {len(exp)} "
        "matches, verified against the oracle")
    return {"partitioned_probe": e}


def probe_pairs(qr: torch.Tensor, rid: torch.Tensor) -> np.ndarray:
    """Sorted (probe rid, match rid) pairs of the matched probe slots."""
    hit = rid >= 0
    pairs = torch.stack([qr[hit], rid[hit]], 1).cpu().numpy()
    pairs = pairs.astype(np.int64)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def run_probe_join(dev, n: int = N_MAIN) -> dict:
    """Phase 7: the partitioned probe join, unique(n, seed 1) x
    uniform(n, seed 2) at 13 bits: ``build_partitioned_table`` and
    ``probe`` each timed with CUDA events after one warm-up, the pairs
    verified against the join oracle."""
    build = unique_relation(n, seed=1, device=dev)
    probe = uniform_relation(n, seed=2, device=dev)
    exp = join_oracle(build, probe)
    pops.probe(*pops.build_partitioned_table(
        build, probe, total_bits=PROBE_BITS)[:3])          # warm-up
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    layout = pops.build_partitioned_table(build, probe,
                                          total_bits=PROBE_BITS)
    ev[1].record()
    rid = pops.probe(*layout[:3])
    ev[2].record()
    ev[2].synchronize()
    counts = rk.launch_counts()
    out = {"n": n, "total_bits": PROBE_BITS,
           "caps": [layout[0].shape[1], layout[2].shape[1]],
           "build_ms": ev[0].elapsed_time(ev[1]),
           "probe_ms": ev[1].elapsed_time(ev[2]), "launches": counts}
    log(f"  layout P={1 << PROBE_BITS} K={out['caps'][0]} "
        f"M={out['caps'][1]}: build_partitioned_table "
        f"{out['build_ms']:.3f} ms, probe {out['probe_ms']:.3f} ms "
        f"(CUDA events), launches {counts}")
    for name in ("hash_bucket", "radix_hist", "partitioned_probe"):
        assert counts[name] > 0, f"partitioned probe join never launched {name}"
    got = probe_pairs(layout[3], rid)
    assert got.shape == exp.shape and np.array_equal(got, exp), \
        "partitioned probe join"
    log(f"  partitioned probe join {n} x {n}: {len(exp)} matches, "
        "verified against the oracle")
    return out


def run_shj(dev, n_main: int = N_MAIN, n_dd: int = N_DD) -> dict:
    """Phase 8: the co-processed SHJ (C = host CPU, G = the card), every
    run verified against the join oracle or the variant oracle."""
    cp = CoProcessor(c_device="cpu", g_device=dev)
    cp_pcie = CoProcessor(c_device="cpu", g_device=dev, link=PCIE_LINK,
                          discrete=True)
    out = {}

    def check(what, res, t, exp, counts, needs_card):
        log(f"  {what}: phases {phase_ms(t)} ms, merge "
            f"{t.merge_s * 1e3:.3f} ms, transfer {t.transfer_bytes} B "
            f"({t.transfer_s * 1e3:.3f} ms emulated), launches {counts}")
        if needs_card:
            assert counts["hash_bucket"] > 0, f"{what} never launched D"
        else:   # the whole series ran on the host
            assert not any(counts.values()), (what, counts)
        verify(res, exp, what)
        out[what] = {"phase_ms": phase_ms(t), "merge_ms": t.merge_s * 1e3,
                     "transfer_bytes": t.transfer_bytes, "launches": counts}

    for n in (n_main, n_dd):
        build = uniform_relation(n, seed=1, device=dev)
        probe = uniform_relation(n, seed=2, device=dev)
        exp = uniform_oracle(n)
        # num_buckets n/4 and max_out 2n + matches, as
        # examples/coprocess_join.py sizes them.
        kw = dict(num_buckets=n // 4, max_out=2 * n + len(exp))
        if n == n_main:
            runs = [("GPU_ONLY", cp, [0.0] * 4, [0.0] * 4, "shared")]
            cp.shj(build, probe, build_ratios=[0.0] * 4,
                   probe_ratios=[0.0] * 4, **kw)                # warm-up
        else:
            runs = [(name, cp, br, pr, mode)
                    for name, br, pr in (
                        ("CPU_ONLY", [1.0] * 4, [1.0] * 4),
                        ("DD", [0.25] * 4, [0.42] * 4),
                        ("PL", [0.0, 0.25, 0.5, 0.25],
                         [0.0, 0.25, 0.75, 0.25]))
                    for mode in ("shared", "separate")]
            runs.append(("DD_PCIE", cp_pcie, [0.25] * 4, [0.42] * 4,
                         "separate"))
        for name, c, br, pr, mode in runs:
            torch.cuda.synchronize()
            rk.reset_launch_counts()
            res, t = c.shj(build, probe, build_ratios=br, probe_ratios=pr,
                           table_mode=mode, **kw)
            counts = rk.launch_counts()
            check(f"shj {name} {mode} n={n}", res, t, exp, counts,
                  name != "CPU_ONLY")
        if n == n_dd:
            torch.cuda.synchronize()
            rk.reset_launch_counts()
            res, t, ratios = cp.basic_unit_shj(build, probe, chunk=n // 16,
                                               **kw)
            counts = rk.launch_counts()
            assert all(0.0 <= r <= 1.0 for r in ratios.values()), ratios
            log(f"  basic_unit_shj chunk={n // 16}: C ratios {ratios}")
            check(f"basic_unit_shj n={n}", res, t, exp, counts, True)
        # Variants against one table from build_table.
        ratios = [0.0] * 4 if n == n_main else [0.25] * 4
        table, _ = cp.build_table(build, num_buckets=kw["num_buckets"],
                                  ratios=ratios)
        for kind in ("semi", "anti", "left_outer"):
            vexp = jv.join_variant_oracle(build, probe, kind)
            pr = [0.0] * 4 if n == n_main else [0.42] * 4
            torch.cuda.synchronize()
            rk.reset_launch_counts()
            res, t = jv.probe_table_variant(cp, probe, table, kind=kind,
                                            max_out=kw["max_out"],
                                            ratios=pr)
            counts = rk.launch_counts()
            check(f"probe_table_variant {kind} "
                  f"{'GPU_ONLY' if n == n_main else 'DD'} n={n}", res, t,
                  vexp, counts, True)
    return out


def time_probe_kernel(dev) -> dict:
    """Phase 6, continued: F at path F's shape (2^24 x 2^24 at 13 bits),
    beside its bytes bound, ``probe_plain`` and the library composite
    (batched ``torch.searchsorted`` + gathers, ``probe_ref``)."""
    build = unique_relation(N_MAIN, seed=1, device=dev)
    probe = uniform_relation(N_MAIN, seed=2, device=dev)
    tk, tr, qk, _ = pops.build_partitioned_table(build, probe,
                                                 total_bits=PROBE_BITS)
    p, k = tk.shape
    m = qk.shape[1]
    hits = int((pprobe.probe(tk, tr, qk) >= 0).sum())
    row = {
        "shape": f"P={p}, K={k}, M={m}, {hits} hits",
        "ms": cuda_ms(lambda: pprobe.probe(tk, tr, qk)),
        "graph_ms": graph_ms(lambda: pprobe.probe(tk, tr, qk)),
        "plain_ms": cuda_ms(lambda: pprobe.probe_plain(tk, tr, qk)),
        "library_ms": cuda_ms(lambda: probe_ref(tk, tr, qk)),
        "library": "composite: batched torch.searchsorted (uint32 order in "
                   "int64) + 2 torch.gather (probe_ref)",
        # Keys and probe keys read once, the match rids written, one rid
        # read per hit.
        "bound_ms": (p * k + 2 * p * m + hits) * 4 / HBM_BYTES_PER_S * 1e3}
    log(f"  partitioned_probe: {row}")
    return {"partitioned_probe": row}


def library_seg_agg(gid: torch.Tensor, val: torch.Tensor, slots: int):
    """The composite yardstick for C: bincount + index_add_ (int64) +
    scatter_reduce_ amin + amax, the PyTorch calls that together compute
    count, sum, min and max per slot."""
    g64 = gid.to(torch.int64)
    v64 = val.to(torch.int64)
    return lambda: (
        torch.bincount(g64, minlength=slots),
        torch.zeros(slots, dtype=torch.int64, device=gid.device)
        .index_add_(0, g64, v64),
        torch.full((slots,), agg.INT32_MAX, dtype=torch.int32,
                   device=gid.device).scatter_reduce_(
                       0, g64, val, "amin", include_self=True),
        torch.full((slots,), agg.INT32_MIN, dtype=torch.int32,
                   device=gid.device).scatter_reduce_(
                       0, g64, val, "amax", include_self=True))


def time_group_kernels(dev) -> dict[str, dict]:
    """Phase 6, continued: C at n = S = 2^24 with sorted gids from 2^18
    groups (the GPU_ONLY unpartitioned group-by's reduce), D at 2^24 with
    B = 2^13 and E at 2^24 with P = 2^13 on uniform and on clustered pids
    (the headers of a (7, 6) schedule)."""
    n = N_MAIN
    keys, value_sets = group_data(n, seed=n)
    skeys = torch.sort(torch.from_numpy(keys).to(dev)).values
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = skeys[1:] != skeys[:-1]
    gid = (torch.cumsum(first, 0, dtype=torch.int32) - 1).to(torch.int32)
    val = torch.from_numpy(value_sets["full"]).to(dev)
    rows = agg.sum_rows(n, False)
    out = {"seg_agg": {
        "shape": f"n=S={n}, {n // 64} groups, sorted gid, {rows} sum rows",
        "ms": cuda_ms(lambda: agg.seg_agg(gid, val, num_slots=n)),
        "plain_ms": cuda_ms(lambda: agg.seg_agg_plain(gid, val,
                                                      num_slots=n)),
        "library_ms": cuda_ms(library_seg_agg(gid, val, n)),
        "library": "bincount + index_add_ int64 + scatter_reduce_ amin + "
                   "amax (summed)",
        "bound_ms": (8 * n + 4 * (3 + rows) * n) / HBM_BYTES_PER_S * 1e3}}
    rel = uniform_relation(n, seed=1, device=dev)
    rel_keys = rel.key
    b = 1 << 13
    out["hash_bucket"] = {
        "shape": f"n={n}, B={b}",
        "ms": cuda_ms(lambda: hsh.hash_bucket(rel_keys, num_buckets=b)),
        "plain_ms": cuda_ms(lambda: hsh.hash_bucket_plain(rel_keys,
                                                          num_buckets=b)),
        "library_ms": None, "library": "none: no PyTorch call hashes",
        "bound_ms": 8 * n / HBM_BYTES_PER_S * 1e3}
    # E on its two inputs: the uniform pids hash_bucket gives the packing
    # of the partitioned probe join, and the clustered pids of the final
    # headers (_headers) of a relation partitioned by the (7, 6) schedule,
    # which phj_join and the partitioned group-by give it.
    parts = radix_partition_scheduled(rel, schedule=(7, 6)).rel
    rows = []
    for name, pid in (("uniform (hash_bucket)",
                       hsh.hash_bucket(rel_keys, num_buckets=b)),
                      ("clustered (_headers after (7, 6))",
                       radix_of(parts.key, shift=0, bits=13))):
        e = max_abs_diff(partition_hist.radix_hist(pid, num_parts=b),
                         partition_hist.radix_hist_plain(pid, num_parts=b))
        assert e == 0, ("radix_hist", name, e)
        run = (lambda: partition_hist.radix_hist(pid, num_parts=b))
        rows.append({
            "shape": f"n={n}, P={b}, {name} pids",
            "ms": cuda_ms(run), "graph_ms": graph_ms(run),
            "plain_ms": cuda_ms(lambda: partition_hist.radix_hist_plain(
                pid, num_parts=b)),
            "library_ms": cuda_ms(lambda: torch.bincount(pid, minlength=b)),
            "library": "torch.bincount",
            "bound_ms": (4 * n + 4 * b) / HBM_BYTES_PER_S * 1e3})
    # The row itself times the uniform input; both stand under per_input.
    out["radix_hist"] = dict(rows[0], per_input=rows)
    for name, row in out.items():
        log(f"  {name}: {row}")
    return out


def time_kernels(dev, sched) -> dict[str, list]:
    """Phase 6: each kernel at the main path's passes (n = 2^24)."""
    rel = uniform_relation(N_MAIN, seed=1, device=dev)
    out = {name: [] for name in ("partition_hist_fused", "radix_scatter")}
    shift = 0
    for bits in sched:
        keys = rel.key
        pid, hist = fused.partition_hist_fused(keys, shift=shift, bits=bits)
        starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
        row_a = {
            "bits": bits, "shift": shift,
            "ms": cuda_ms(lambda: fused.partition_hist_fused(
                keys, shift=shift, bits=bits)),
            "plain_ms": cuda_ms(lambda: fused.partition_hist_fused_plain(
                keys, shift=shift, bits=bits)),
            "library_ms": cuda_ms(lambda: torch.bincount(
                pid, minlength=1 << bits))}
        row_b = {
            "bits": bits, "shift": shift,
            "path": ("shared memory" if reorder.uses_shared(1 << bits)
                     else "device memory"),
            "ms": cuda_ms(lambda: reorder.radix_scatter(
                rel.rid, keys, pid, starts, num_parts=1 << bits)),
            "plain_ms": cuda_ms(lambda: reorder.radix_scatter_plain(
                rel.rid, keys, pid)),
            "library_ms": cuda_ms(lambda: (lambda o: (rel.rid[o], keys[o]))(
                torch.sort(pid, stable=True).indices))}
        row_b["vs_library"] = ("no slower" if row_b["ms"] <= row_b[
            "library_ms"] else "slower")
        for name, row in (("partition_hist_fused", row_a),
                          ("radix_scatter", row_b)):
            row["bound_ms"] = (KERNELS[name]["bytes_per_tuple"] * N_MAIN
                               / HBM_BYTES_PER_S * 1e3)
            out[name].append(row)
            log(f"  {name} bits={bits}: {row}")
        rel = type(rel)(*reorder.radix_scatter(rel.rid, keys, pid, starts,
                                               num_parts=1 << bits))
        shift += bits
    return out


def close_err(got: torch.Tensor, want: torch.Tensor, tol: float,
              what) -> float:
    """Largest |got - want|; raises unless every element is within
    ``tol + tol |want|`` (tests/test_kernels.py's assert_allclose)."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert bool(torch.isfinite(got).all()), (what, "non-finite output")
    diff = (got - want).abs()
    assert bool((diff <= tol + tol * want.abs()).all()), \
        (what, float(diff.max()))
    return float(diff.max())


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """RMS(got - want) / RMS(want), in float32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def g_close(got: torch.Tensor, want: torch.Tensor, what) -> dict:
    """G's output against its plain version: within TOL_G elementwise and
    within REL_G of want's RMS.  Returns both readings."""
    err = close_err(got, want, TOL_G[want.dtype], what)
    rel = rel_rms(got, want)
    assert rel <= REL_G[want.dtype], (what, rel, REL_G[want.dtype])
    return {"max_abs_err": err, "rel_rms": rel}


def g_inputs(shape, dtype, dev, seed: int):
    b, sq, sk, h, kv, d, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype),
            torch.randn(b, sk, kv, d, generator=g, device=dev).to(dtype),
            torch.randn(b, sk, kv, d, generator=g, device=dev).to(dtype))


def h_inputs(shape, dtype, dev, seed: int):
    bs, nc, q, h, p, n = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(bs, nc, q, h, p, generator=g, device=dev).to(dtype),
            torch.rand(bs, nc, q, h, generator=g, device=dev) * 0.19 + 0.01,
            torch.randn(bs, nc, q, n, generator=g, device=dev).to(dtype),
            torch.randn(bs, nc, q, n, generator=g, device=dev).to(dtype),
            -torch.exp(torch.randn(h, generator=g, device=dev) * 0.3))


def check_lm_kernels(dev) -> dict[str, float]:
    """Phase 9: kernels G and H against their plain versions over their
    grids, in float32 (TF32 off) and in bfloat16; H in both variants:
    bfloat16 through the tensor-core (wgmma) variant that serves it, and
    through the CUDA-core variant too, which serves float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err = {"flash_attn": 0.0, "ssd_intra_chunk": 0.0}
    for dtype, tol in TOL_G.items():
        for i, shape in enumerate(GRID_G):
            q, k, v = g_inputs(shape, dtype, dev, seed=i)
            kv, causal = shape[4], shape[6]
            got = fa.flash_attention(q, k, v, num_kv_heads=kv, causal=causal)
            want = fa.flash_attention_plain(q, k, v, num_kv_heads=kv,
                                            causal=causal)
            e = g_close(got, want, ("flash_attn", shape, dtype))
            err["flash_attn"] = max(err["flash_attn"], e["max_abs_err"])
            log(f"  G {shape} {dtype}: max abs err {e['max_abs_err']:.3g} "
                f"(tol {tol}), rel RMS {e['rel_rms']:.3g} "
                f"(limit {REL_G[dtype]})")
            del q, k, v, got, want
    by_variant = {}
    for dtype, variant in ((torch.bfloat16, None),
                           (torch.bfloat16, "cuda_cores"),
                           (torch.float32, None)):
        tol = TOL_H[dtype]
        for i, shape in enumerate(GRID_H):
            args = h_inputs(shape, dtype, dev, seed=i)
            before = dict(kssd.launches_by_variant)
            got = kssd.ssd_intra_chunk(*args, variant=variant)
            ran = next(n for n, c in kssd.launches_by_variant.items()
                       if c != before[n])
            assert ran == (variant or kssd.variant_for(dtype)), (shape, ran)
            want = kssd.ssd_intra_chunk_plain(*args)
            e = close_err(got, want, tol, ("ssd_intra_chunk", shape, dtype))
            err["ssd_intra_chunk"] = max(err["ssd_intra_chunk"], e)
            key = f"{ran} {str(dtype).replace('torch.', '')}"
            by_variant[key] = max(by_variant.get(key, 0.0), e)
            log(f"  H {shape} {dtype} {ran}: max abs err {e:.3g} "
                f"(tol {tol} + {tol} |want|)")
    for key, e in by_variant.items():
        log(f"  H {key}: largest error over GRID_H {e:.3g}")
    assert kssd.variant_for(torch.bfloat16) == "wgmma"
    torch.cuda.synchronize()
    return err


class Spy:
    """Calls ``enter(args, kw)`` before and ``on_call(args, kw, out)``
    after every call of ``module.name`` while inside, and passes each call
    on unchanged."""

    def __init__(self, module, name: str, on_call):
        self.module, self.name, self.on_call = module, name, on_call

    def enter(self, args, kw) -> None:
        pass

    def __enter__(self):
        # Read on entry, so that spies on one function nest.
        self.fn = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            self.enter(args, kw)
            out = self.fn(*args, **kw)
            self.on_call(args, kw, out)
            return out
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class Capture(Spy):
    """Records the inputs of the first call of ``module.name`` while the
    prefill runs (clones of its tensors, its other arguments as they are,
    and its keywords, in ``args``), and passes every call on unchanged."""

    def __init__(self, module, name: str):
        super().__init__(module, name, self._first)
        self.args = None

    def _first(self, args, kw, out):
        if self.args is None:
            self.args = ([a.clone() if torch.is_tensor(a) else a
                          for a in args], dict(kw))


class GLaunches(Spy):
    """Adds kernel G's launches made inside each call of ``module.name``
    to ``counts[key(kw)]``."""

    def __init__(self, module, name: str, counts: dict, key):
        super().__init__(module, name, self._count)
        self.counts, self.key = counts, key

    def enter(self, args, kw) -> None:
        self.before = fa.launches

    def _count(self, args, kw, out):
        self.counts[self.key(kw)] += fa.launches - self.before


@contextlib.contextmanager
def moe_probe():
    """While inside, each MoE call's routes (tokens, k) and how many
    (token, slot) pairs its expert buffers kept (their non-zero rows), as
    tensors on the card: nothing waits for the device."""
    rec = {"routes": [], "kept": []}
    with Spy(lmoe, "_route", lambda a, kw, out: rec["routes"].append(
            out[0].reshape(-1, out[0].shape[-1]))), \
            Spy(lmoe, "_experts_ffn", lambda a, kw, out: rec["kept"].append(
                (a[1] != 0).any(-1).sum())):
        yield rec


def dropped_pairs(rec) -> list[int]:
    """Per MoE call of a ``moe_probe`` record: (token, slot) pairs routed
    minus pairs kept, the pairs its capacity dropped."""
    return [r.numel() - int(k) for r, k in zip(rec["routes"], rec["kept"])]


def timed_generate(engine: ServeEngine, prompts: torch.Tensor, new: int,
                   dev, frames=None) -> tuple:
    """One ``engine.generate`` (of an encoder-decoder config: over
    ``frames``) with its logits, timed with CUDA events after a
    synchronize, with the launch counts (and G's and H's by variant) and
    the peak device memory of that run alone.  Returns (tokens, logits,
    info); the tokens are checked for shape, prompt and vocabulary, the
    logits for finiteness."""
    cfg = engine.cfg
    batch, plen = prompts.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rk.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    tokens, logits = engine.generate(prompts, new, frames,
                                     return_logits=True)
    ev[1].record()
    ev[1].synchronize()
    info = {"generate_ms": ev[0].elapsed_time(ev[1]),
            "launches": rk.launch_counts(),
            "flash_attn_variants": dict(fa.launches_by_variant),
            "ssd_intra_chunk_variants": dict(kssd.launches_by_variant),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    info["tokens_per_s"] = batch * new / (info["generate_ms"] / 1e3)
    assert tokens.shape == (batch, plen + new)
    assert torch.equal(tokens[:, :plen].cpu(), prompts.cpu())
    assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    assert bool(torch.isfinite(logits.float()).all())
    return tokens, logits, info


def time_steps(cfg, params, prompts: torch.Tensor, new: int, dev,
               frames=None) -> dict:
    """The prefill step (of an encoder-decoder config: over ``frames``,
    the encoder included) and the ``new - 1`` decode steps of a generate,
    each timed alone with CUDA events, and the decode steps' launches."""
    batch, plen = prompts.shape
    prefill = make_prefill_step(cfg)
    step = make_decode_step(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    plog, cache = prefill(params, {"tokens": prompts, "enc_frames": frames})
    ev[1].record()
    cache = grow_cache(cache, plen + new)
    tok = torch.argmax(plog, -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    ev[2].record()
    for n in range(plen, plen + new - 1):
        tok, _, cache = step(params, cache, tok, n)
    ev[3].record()
    ev[3].synchronize()
    decode_ms = ev[2].elapsed_time(ev[3]) / (new - 1)
    return {"prefill_ms": ev[0].elapsed_time(ev[1]),
            "decode_ms_per_step": decode_ms,
            "decode_tokens_per_s": batch / (decode_ms / 1e3),
            "decode_launches": rk.launch_counts()}


def logits_diff(got: torch.Tensor, ref: torch.Tensor, vocab: int) -> tuple:
    """max|got - ref| / max|ref| over the real vocabulary (the padding is
    -1e9 in both), and the share of positions whose argmax agrees."""
    got, ref = got.float()[..., :vocab], ref.float()[..., :vocab]
    rel = float((got - ref).abs().max() / ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    return rel, agree


def run_lm_serving(dev, cfg, batches=LM_BATCHES) -> dict:
    """Phase 10: ``cfg`` (Zamba2-1.2B at full width and depth in the run
    of ``main``; random weights from seed 0) served through
    ``ServeEngine.generate`` for each (batch, prompt, new) of ``batches``;
    launch
    counts per generate (G and H only in the prefill), decode logits
    against ``forward_train`` (G and H) on the generated sequences, G and
    H against their plain versions on the prefill's own activations, and
    CUDA-event times."""
    layers = cfg.pattern_unit * cfg.num_units + cfg.tail
    n_attn, n_mamba = layers.count("A") + layers.count("D"), layers.count("M")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  {cfg.name}: {cfg.num_layers} layers ({layers}), {n_params} "
        f"parameters, initialised in {time.perf_counter() - t0:.1f} s")
    out = {"arch": cfg.name, "params": n_params, "batches": {}}
    for bi, (batch, plen, new) in enumerate(batches):
        rng = np.random.default_rng(bi)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, plen), dtype=np.int32)).to(dev)
        engine = ServeEngine(cfg, params, max_seq=plen + new)
        what = f"{batch} x {plen} + {new}"
        if bi == 0:   # warm-up, with the activations of one G and one H
            with Capture(lattn, "flash_attention") as cg, \
                    Capture(lssd, "ssd_intra_chunk") as ch:
                engine.generate(prompts, new)
        else:
            engine.generate(prompts, new)
        tokens, logits, info = timed_generate(engine, prompts, new, dev)
        counts = info["launches"]
        variants = info["flash_attn_variants"]
        h_variants = info["ssd_intra_chunk_variants"]
        log(f"  generate {what}: {info['generate_ms']:.3f} ms, launches "
            f"{counts}, G by variant {variants}, H by variant {h_variants}, "
            f"peak {info['peak_bytes']} B")
        assert counts["flash_attn"] == n_attn, counts
        assert variants["wgmma"] == n_attn, variants   # head_dim 64, bf16
        assert counts["ssd_intra_chunk"] == n_mamba, counts
        assert h_variants["wgmma"] == n_mamba, h_variants   # bf16
        assert sum(counts.values()) == n_attn + n_mamba, counts

        # Decode (plain attention, recurrent SSD) against forward_train
        # (G and H) at every generated position.
        rk.reset_launch_counts()
        full, _ = tfm.forward_train(params, cfg, tokens[:, :-1])
        fwd_counts = rk.launch_counts()
        assert fwd_counts["flash_attn"] == n_attn, fwd_counts
        assert fwd_counts["ssd_intra_chunk"] == n_mamba, fwd_counts
        rel, agree = logits_diff(logits, full[:, plen - 1:], cfg.vocab_size)
        log(f"  decode vs forward_train logits: max|d|/max|logits| "
            f"{rel:.4g} (limit {LM_REL_LIMIT}); argmax agreement {agree}")
        assert rel < LM_REL_LIMIT, (what, rel)
        del full

        steps = time_steps(cfg, params, prompts, new, dev)
        assert not any(steps["decode_launches"].values()), steps
        row = {"batch": batch, "prompt": plen, "new": new, **info,
               **steps, "rel_logits": rel, "argmax_agreement": agree}
        log(f"  {what}: prefill {row['prefill_ms']:.3f} ms, decode "
            f"{row['decode_ms_per_step']:.3f} ms per step, "
            f"{row['tokens_per_s']:.1f} tok/s over generate")
        out["batches"][what] = row
        del tokens, logits

    # G and H on the prefill's own activations (first attention block,
    # first Mamba2 block of the 4 x 2048 warm-up prefill).
    (q, k, v), kw = cg.args
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    eg = close_err(got, want, TOL_G[q.dtype], "G on Zamba2 activations")
    args, _ = ch.args
    before = kssd.launches_by_variant["wgmma"]
    got = kssd.ssd_intra_chunk(*args)
    assert kssd.launches_by_variant["wgmma"] == before + 1
    want = kssd.ssd_intra_chunk_plain(*args)
    eh = close_err(got, want, TOL_H[args[0].dtype],
                   "H on Zamba2 activations")
    log(f"  real activations: G q {tuple(q.shape)} err {eg:.3g}; H x "
        f"{tuple(args[0].shape)} err {eh:.3g}")
    out["activation_err"] = {"flash_attn": eg, "ssd_intra_chunk": eh}
    return out


def free_card() -> None:
    """Return the cached blocks of freed tensors to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def init_lm(cfg, dev):
    """``cfg``'s LM with random weights from seed 0, and its size."""
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    log(f"  {cfg.name} ({cfg.dtype}): {cfg.num_layers} layers, {n} "
        f"parameters, initialised in {time.perf_counter() - t0:.1f} s")
    return params, n


def routes_differ(a: list, b: list) -> int:
    """(token, layer) pairs whose k experts differ between two probes."""
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))


def serve_moe(cfg, params, prompts, new: int, dev, *, n_moe: int,
              n_attn: int, variant: str, full: bool = True) -> dict:
    """One served batch of an MoE config under ``cfg.moe_impl``: a
    warm-up ``generate`` probed for routes and dropped pairs, a timed one
    whose launches are checked (G ``n_attn`` times in ``variant``, E
    ``n_moe`` times per prefill and per decode step under ``sorted``,
    none under ``dense``), with ``full`` its decode logits against
    ``forward_train``, and the two steps timed alone."""
    batch, plen = prompts.shape
    sorted_ = cfg.moe_impl == "sorted"
    engine = ServeEngine(cfg, params, max_seq=plen + new)
    with moe_probe() as probe:
        engine.generate(prompts, new)
    drops = dropped_pairs(probe)
    assert len(drops) == n_moe * new, len(drops)
    tokens, logits, info = timed_generate(engine, prompts, new, dev)
    counts = info["launches"]
    want_e = n_moe * new if sorted_ else 0
    assert counts["flash_attn"] == n_attn, counts
    assert info["flash_attn_variants"][variant] == n_attn, info
    assert counts["radix_hist"] == want_e, counts
    assert sum(counts.values()) == n_attn + want_e, counts
    row = {"batch": batch, "prompt": plen, "new": new, **info,
           "dropped_pairs_prefill_by_layer": drops[:n_moe],
           "dropped_pairs_decode": sum(drops[n_moe:])}
    if full:
        fwd, aux = tfm.forward_train(params, cfg, tokens[:, :-1])
        row["rel_logits"], row["argmax_agreement"] = logits_diff(
            logits, fwd[:, plen - 1:], cfg.vocab_size)
        row["forward_train_aux"] = float(aux)
        del fwd
    steps = time_steps(cfg, params, prompts, new, dev)
    assert steps["decode_launches"]["radix_hist"] == (
        n_moe * (new - 1) if sorted_ else 0), steps
    row.update(steps)
    log(f"  {cfg.moe_impl} {batch} x {plen} + {new}: generate "
        f"{row['generate_ms']:.3f} ms ({row['tokens_per_s']:.1f} tok/s), "
        f"prefill {row['prefill_ms']:.3f} ms, decode "
        f"{row['decode_ms_per_step']:.3f} ms/step, peak "
        f"{row['peak_bytes']} B, launches {counts}; dropped pairs per "
        f"prefill layer {row['dropped_pairs_prefill_by_layer']}, in decode "
        f"{row['dropped_pairs_decode']}; decode vs forward_train "
        f"{row.get('rel_logits')} (argmax {row.get('argmax_agreement')})")
    return {"row": row, "logits": logits, "routes": probe["routes"][:n_moe]}


def compare_engines(runs: dict, vocab: int) -> dict:
    """Dense against sorted: prefill logits and routes."""
    rel, agree = logits_diff(runs["sorted"]["logits"][:, 0],
                             runs["dense"]["logits"][:, 0], vocab)
    out = {"rel_prefill_logits": rel, "argmax_agreement": agree,
           "routes_differ": routes_differ(runs["dense"]["routes"],
                                          runs["sorted"]["routes"]),
           "routes": sum(r.shape[0] for r in runs["dense"]["routes"])}
    log(f"  dense vs sorted: prefill logits {rel:.4g}, argmax agreement "
        f"{agree}, {out['routes_differ']} of {out['routes']} (token, "
        "layer) routes differ")
    return out


def check_moe_layer(cfg, mparams, x) -> dict:
    """``moe_dense`` against ``moe_sorted`` on a block's own activations,
    in float32 at the drop-free capacity (E / k)."""
    m = cfg.moe
    cfg32 = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    assert "shared" not in mparams
    p32 = {k: mparams[k].float() for k in ("router", "wi_gate", "wi_up",
                                           "wo")}
    x32 = x.float()
    yd, ad = lmoe.moe_dense(p32, cfg32, x32)
    ys, as_ = lmoe.moe_sorted(p32, cfg32, x32)
    rel = float((yd - ys).abs().max() / yd.abs().max())
    aux_rel = abs(float(ad) - float(as_)) / abs(float(ad))
    log(f"  moe_dense vs moe_sorted, float32, capacity factor "
        f"{cfg32.moe.capacity_factor}, x {tuple(x.shape)}: max|d|/max|y| "
        f"{rel:.3g} (limit {MOE_LAYER_REL}), aux {float(ad):.6g} vs "
        f"{float(as_):.6g} (rel {aux_rel:.3g}, limit {MOE_AUX_REL})")
    assert rel <= MOE_LAYER_REL, rel
    assert aux_rel <= MOE_AUX_REL, aux_rel
    return {"rel": rel, "aux_rel": aux_rel}


def run_moe_serving(dev) -> dict:
    """Phase 13: granite_moe_3b at full width and depth (bf16, random
    weights from seed 0) served through ``ServeEngine.generate`` for each
    batch of LM_BATCHES under both dispatch engines, then in float32 at
    the drop-free capacity (decode against ``forward_train``, dense
    against sorted), the MoE layer, E and G on the prefill's own
    activations, and one full-width llama4_maverick_400b unit (DE)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            m.num_experts, m.top_k, m.d_ff, cfg.dtype) == (
                32, 1536, 24, 8, 40, 8, 512, "bfloat16"), cfg
    n = cfg.num_layers
    params, n_params = init_lm(cfg, dev)
    out = {"arch": cfg.name, "params": n_params, "served": {},
           "dense_vs_sorted": {}}
    prompts_of = {}
    for bi, (batch, plen, new) in enumerate(LM_BATCHES):
        rng = np.random.default_rng(bi)
        prompts = prompts_of[bi] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, plen), dtype=np.int32)).to(dev)
        what = f"{batch} x {plen} + {new}"
        runs = {}
        for impl in MOE_ENGINES:
            ecfg = dataclasses.replace(cfg, moe_impl=impl)
            with contextlib.ExitStack() as stack:
                if bi == 0 and impl == "dense":  # the first E block's input
                    moe_in = []
                    stack.enter_context(Spy(lmoe, "moe", lambda a, kw, o: (
                        moe_in or moe_in.append((a[0], a[2].clone())))))
                    cg = stack.enter_context(Capture(lattn,
                                                     "flash_attention"))
                if bi == 0 and impl == "sorted":  # E's pids, every call
                    pids = []
                    stack.enter_context(Spy(
                        cpart, "radix_hist",
                        lambda a, kw, o: pids.append(a[0].clone())))
                runs[impl] = serve_moe(ecfg, params, prompts, new, dev,
                                       n_moe=n, n_attn=n, variant="wgmma")
            out["served"][f"{impl} {what}"] = runs[impl]["row"]
        out["dense_vs_sorted"][what] = compare_engines(runs, cfg.vocab_size)
        del runs

    # The MoE layer, E and G on the 4 x 2048 prefill's own activations.
    mparams, x = moe_in[0]
    out["layer"] = check_moe_layer(cfg, mparams, x)
    # pids[0]: the probed prefill's first layer; pids[n]: its first
    # decode step's.
    assert pids[0].shape == (m.top_k * x.shape[0] * x.shape[1],)
    assert pids[n].shape == (m.top_k * x.shape[0],)
    for pid in pids:
        assert torch.equal(
            partition_hist.radix_hist(pid, num_parts=m.num_experts),
            partition_hist.radix_hist_plain(pid, num_parts=m.num_experts))
    (q, k, v), kw = cg.args
    eg = close_err(fa.flash_attention(q, k, v, **kw),
                   fa.flash_attention_plain(q, k, v, **kw), TOL_G[q.dtype],
                   "G on granite activations")
    out["activation_err"] = {"flash_attn": eg, "radix_hist": 0}
    out["router_pids"] = {
        f"prefill {LM_BATCHES[0][0]} x {LM_BATCHES[0][1]}": pids[0],
        f"decode step, batch {LM_BATCHES[0][0]}": pids[n]}
    out["router_parts"] = m.num_experts
    log(f"  real activations: E bit-exact on {len(pids)} pid vectors "
        f"({pids[0].numel()} and {pids[n].numel()} pids); G q "
        f"{tuple(q.shape)} err {eg:.3g}")
    del params, mparams, x, moe_in, cg
    free_card()

    # Float32 at the drop-free capacity: the same seed-0 draws, unrounded.
    cfg32 = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    params, _ = init_lm(cfg32, dev)
    batch, plen, new = LM_BATCHES[1]
    runs = {}
    for impl in MOE_ENGINES:
        ecfg = dataclasses.replace(cfg32, moe_impl=impl)
        runs[impl] = serve_moe(ecfg, params, prompts_of[1], new, dev,
                               n_moe=n, n_attn=n, variant="cuda_cores")
        row = runs[impl]["row"]
        assert not any(row["dropped_pairs_prefill_by_layer"]), row
        assert row["rel_logits"] < LM_REL_LIMIT, row["rel_logits"]
        out["served"][f"float32 {impl} {batch} x {plen} + {new}"] = row
    cmp = compare_engines(runs, cfg.vocab_size)
    assert cmp["rel_prefill_logits"] < LM_REL_LIMIT, cmp
    out["dense_vs_sorted"][f"float32 {batch} x {plen} + {new}"] = cmp
    del params, runs
    free_card()

    # One full-width llama4 unit (DE: a dense layer, then 128 experts
    # top-1 with a shared expert).
    cfg4 = dataclasses.replace(get_config(MOE_UNIT_ARCH), num_layers=2)
    m4 = cfg4.moe
    assert (cfg4.d_model, cfg4.num_heads, cfg4.num_kv_heads,
            cfg4.resolved_head_dim, m4.num_experts, m4.top_k, m4.d_ff,
            m4.shared_d_ff, cfg4.pattern_unit, cfg4.dtype) == (
                5120, 40, 8, 128, 128, 1, 8192, 8192, "DE", "bfloat16"), cfg4
    params, n4 = init_lm(cfg4, dev)
    batch, plen, new = MOE_UNIT_BATCH
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg4.vocab_size, (batch, plen), dtype=np.int32)).to(dev)
    runs = {}
    for impl in MOE_ENGINES:
        ecfg = dataclasses.replace(cfg4, moe_impl=impl)
        runs[impl] = serve_moe(ecfg, params, prompts, new, dev, n_moe=1,
                               n_attn=2, variant="wgmma", full=False)
    out["unit"] = {"arch": cfg4.name, "layers": cfg4.num_layers,
                   "params": n4,
                   "served": {k: r["row"] for k, r in runs.items()},
                   "dense_vs_sorted": compare_engines(runs,
                                                      cfg4.vocab_size)}
    del params, runs
    free_card()
    return out


def encdec_frames(cfg, batch: int, rng, dev) -> torch.Tensor:
    """Stub frame embeddings (B, F, d_model) as the serve CLIs draw them:
    ``standard_normal * 0.02`` in the model's dtype, from ``rng`` right
    after the prompts."""
    return torch.from_numpy(rng.standard_normal(
        (batch, cfg.encoder.num_frames, cfg.d_model)) * 0.02).to(
            dev, torch_dtype(cfg.dtype))


def cross_kv_kept(cfg, params, prompts, frames, max_seq: int) -> bool:
    """Whether ``grow_cache`` hands on the prefill's own ``ck`` / ``cv``
    tensors in every decoder block (no copy, not zeros)."""
    _, cache = make_prefill_step(cfg)(params, {"tokens": prompts,
                                               "enc_frames": frames})
    grown = grow_cache(cache, max_seq)
    return all(grown["unit"][i][key][name] is blk[name]
               for i, unit in enumerate(cache["unit"])
               for key, blk in unit.items() for name in ("ck", "cv"))


def serve_encdec(cfg, params, prompts, frames, new: int, dev, *,
                 variant: str, captures=()) -> dict:
    """One served batch of an encoder-decoder config: a warm-up
    ``generate`` (inside ``captures``), a timed one whose G launches are
    split by layer (as many in the encoder, the decoder's self-attention
    and its cross attention as each has layers, all in ``variant``), its
    decode logits against ``forward_train`` on the generated sequence,
    the grown cache's cross K/V, the encoder and the steps timed alone."""
    batch, plen = prompts.shape
    n_enc, n_dec = cfg.encoder.num_layers, cfg.num_layers
    engine = ServeEngine(cfg, params, max_seq=plen + new)
    with contextlib.ExitStack() as stack:
        for c in captures:
            stack.enter_context(c)
        engine.generate(prompts, new, frames)
    # G's launches by layer: the attention layer's ``attention`` (the
    # encoder's self-attention is its non-causal call) and
    # ``cross_attention``.
    split = dict.fromkeys(("encoder", "decoder_self", "cross"), 0)
    with GLaunches(lattn, "attention", split, lambda kw: (
            "decoder_self" if kw["causal"] else "encoder")), \
            GLaunches(lattn, "cross_attention", split, lambda kw: "cross"):
        tokens, logits, info = timed_generate(engine, prompts, new, dev,
                                              frames)
    counts = info["launches"]
    n_g = n_enc + 2 * n_dec
    assert split == {"encoder": n_enc, "decoder_self": n_dec,
                     "cross": n_dec}, split
    assert counts["flash_attn"] == n_g, counts
    assert info["flash_attn_variants"][variant] == n_g, info
    assert sum(counts.values()) == n_g, counts
    row = {"batch": batch, "prompt": plen, "new": new, **info,
           "flash_attn_by_layer": dict(split)}
    rk.reset_launch_counts()
    full, _ = tfm.forward_train(params, cfg, tokens[:, :-1], frames)
    row["forward_train_launches"] = rk.launch_counts()
    assert row["forward_train_launches"]["flash_attn"] == n_g, row
    row["rel_logits"], row["argmax_agreement"] = logits_diff(
        logits, full[:, plen - 1:], cfg.vocab_size)
    assert row["rel_logits"] < LM_REL_LIMIT, row["rel_logits"]
    del full, tokens, logits
    row["cross_kv_kept"] = cross_kv_kept(cfg, params, prompts, frames,
                                         plen + new)
    assert row["cross_kv_kept"]
    row["encoder_ms"] = cuda_ms(lambda: tfm._encode(params, cfg, frames),
                                reps=2, warmup=1)
    steps = time_steps(cfg, params, prompts, new, dev, frames)
    assert not any(steps["decode_launches"].values()), steps
    row.update(steps)
    log(f"  {cfg.dtype} {batch} x {plen} + {new}: generate "
        f"{row['generate_ms']:.3f} ms ({row['tokens_per_s']:.1f} tok/s), "
        f"encoder {row['encoder_ms']:.3f} ms, prefill "
        f"{row['prefill_ms']:.3f} ms (encoder included), decode "
        f"{row['decode_ms_per_step']:.3f} ms/step, peak "
        f"{row['peak_bytes']} B; G by layer {row['flash_attn_by_layer']}, "
        f"by variant {info['flash_attn_variants']}; decode launches "
        f"{steps['decode_launches']}; decode vs forward_train "
        f"{row['rel_logits']:.4g} (limit {LM_REL_LIMIT}, argmax agreement "
        f"{row['argmax_agreement']}); grown ck / cv are the prefill's")
    return row


def run_encdec_serving(dev) -> dict:
    """Phase 14: whisper_large_v3 at full width and depth (bf16, random
    weights from seed 0, stub frames as the CLI draws them) served through
    ``ServeEngine.generate`` for each batch of ENCDEC_BATCHES, then in
    float32 (G's ``cuda_cores``) at ENCDEC_F32_BATCH; G on the first
    encoder block's and the first cross attention's own activations."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ENCDEC_ARCH)
    assert (cfg.num_layers, cfg.encoder.num_layers, cfg.encoder.num_frames,
            cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.dtype) == (
                32, 32, 1500, 1280, 20, 20, 5120, 51866, "bfloat16"), cfg
    params, n_params = init_lm(cfg, dev)
    out = {"arch": cfg.name, "params": n_params, "served": {}}
    enc_g = Capture(lattn, "flash_attention")
    cross_g = Capture(lattn, "cross_attention")
    for bi, (batch, plen, new) in enumerate(ENCDEC_BATCHES):
        rng = np.random.default_rng(bi)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, plen), dtype=np.int32)).to(dev)
        frames = encdec_frames(cfg, batch, rng, dev)
        out["served"][f"{batch} x {plen} + {new}"] = serve_encdec(
            cfg, params, prompts, frames, new, dev, variant="wgmma",
            captures=(enc_g, cross_g) if bi == 0 else ())
        del prompts, frames
        free_card()

    # G on the 8 x 4 prefill's own activations: the first encoder block's
    # self-attention (the first G call) and the first cross attention
    # (its query projected as ``cross_attention`` projects it).
    (cparams, _, x, (ck, cv)), _ = cross_g.args
    g_args = {"encoder": enc_g.args,
              "cross": ((lattn._proj(x, cparams["wq"]), ck.contiguous(),
                         cv.contiguous()),
                        {"num_kv_heads": cfg.num_kv_heads, "causal": False})}
    errs = {}
    for what, ((q, k, v), kw) in g_args.items():
        assert kw["causal"] is False, (what, kw)
        errs[what] = g_close(fa.flash_attention(q, k, v, **kw),
                             fa.flash_attention_plain(q, k, v, **kw),
                             f"G on whisper {what}")
        log(f"  real activations, {what}: G q {tuple(q.shape)} over k "
            f"{tuple(k.shape)}, max abs err {errs[what]['max_abs_err']:.3g} "
            f"(tol {TOL_G[q.dtype]}), rel RMS {errs[what]['rel_rms']:.3g} "
            f"(limit {REL_G[q.dtype]})")
    out["activation_err"] = errs
    del params, enc_g, cross_g, g_args, cparams, x, ck, cv, q, k, v
    free_card()

    # Float32: the same seed-0 draws, unrounded; G's CUDA-core variant.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params, _ = init_lm(cfg32, dev)
    batch, plen, new = ENCDEC_F32_BATCH
    rng = np.random.default_rng(len(ENCDEC_BATCHES))
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, plen), dtype=np.int32)).to(dev)
    frames = encdec_frames(cfg32, batch, rng, dev)
    row = serve_encdec(cfg32, params, prompts, frames, new, dev,
                       variant="cuda_cores")
    out["served"][f"float32 {batch} x {plen} + {new}"] = row
    assert row["rel_logits"] < ENCDEC_F32_REL_LIMIT, row["rel_logits"]
    del params, prompts, frames
    free_card()
    return out


def time_router_hist(pids: dict, p: int) -> list[dict]:
    """Phase 6, continued: E at the router's shapes (granite's 65,536
    prefill pids and 32 decode pids into its 40 experts), back to back
    and in a CUDA graph, beside its plain version and ``torch.bincount``
    (which waits for the device to size its output, so no graph)."""
    rows = []
    for name, pid in pids.items():
        n = pid.numel()
        run = (lambda: partition_hist.radix_hist(pid, num_parts=p))
        rows.append({
            "shape": f"n={n}, P={p}, router pids (granite {name})",
            "ms": cuda_ms(run), "graph_ms": graph_ms(run),
            "plain_ms": cuda_ms(lambda: partition_hist.radix_hist_plain(
                pid, num_parts=p)),
            "library_ms": cuda_ms(lambda: torch.bincount(pid, minlength=p)),
            "library": f"torch.bincount(minlength={p})",
            "bound_ms": (4 * n + 4 * p) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"})
        log(f"  radix_hist router {name}: {rows[-1]}")
    return rows


def library_ssd(x, dt, b, c, a):
    """The composite yardstick for H: two batched torch.matmul (C B^T and
    W X) around the decay mask, in float32; Y comes out (B, NC, H, Q, P)."""
    dth = dt.permute(0, 1, 3, 2)                          # (B,NC,H,Q)
    cs = torch.cumsum(dth * a[:, None], dim=-1)
    q = x.shape[2]
    tril = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    decay = torch.exp(cs[..., :, None] - cs[..., None, :]).masked_fill(
        ~tril, 0.0)
    g = torch.matmul(c.float(), b.float().transpose(-1, -2))
    w = g[:, :, None] * decay * dth[..., None, :]
    return torch.matmul(w, x.float().permute(0, 1, 3, 2, 4))


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """Least milliseconds for the work, and what bounds it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def time_g(dev, b: int, s: int, h: int, kv: int, d: int, *,
           sk: int | None = None, causal: bool = True) -> dict:
    """G at q (b, s, h, d), k/v (b, sk, kv, d) bf16 (sk defaults to s)
    beside its operations bound, its plain version and SDPA on the same
    views."""
    sk = s if sk is None else sk
    q, k, v = g_inputs((b, s, sk, h, kv, d, causal), torch.bfloat16, dev,
                       99)
    # The (i, j) pairs the function weighs: causal j <= i (square only).
    pairs = s * (s + 1) // 2 if causal else s * sk
    bms, bby = bound(4.0 * b * h * pairs * d,
                     2 * 2 * b * (s * h + sk * kv) * d, BF16_FLOPS)
    before = dict(fa.launches_by_variant)
    fa.flash_attention(q, k, v, num_kv_heads=kv, causal=causal)
    variant = next(n for n, c in fa.launches_by_variant.items()
                   if c != before[n])
    row = {
        "shape": f"q ({b}, {s}, {h}, {d}), k/v ({b}, {sk}, {kv}, {d}) bf16, "
                 + ("causal" if causal else "non-causal"),
        "variant": variant,
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, num_kv_heads=kv,
                                                 causal=causal)),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, num_kv_heads=kv, causal=causal), reps=3, warmup=1),
        "library_ms": cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=kv != h)),
        "library": "torch.nn.functional.scaled_dot_product_attention "
                   f"(is_causal={causal}) on (B, H, S, D) views",
        "bound_ms": bms, "bound_by": bby}
    row["vs_library"] = ("no slower" if row["ms"] <= row["library_ms"]
                         else "slower")
    return row


def time_lm_kernels(dev) -> dict[str, dict]:
    """Phase 6, continued: G at Zamba2's prefill shape (4 x 2048 x 32
    heads of 64), at the Qwen3-8B-shaped GQA shape of ``GRID_G`` (2048,
    32 / 8 heads of 128) and non-causal at whisper's encoder (8 x 1500 x
    20 / 20 heads of 64) and cross attention shapes (4 x 224 queries over
    1500 frames), H at Zamba2's prefill shape, all bf16, beside their
    bounds, plain versions and library calls."""
    zamba = time_g(dev, 4, 2048, 32, 32, 64)
    gqa = time_g(dev, 1, 2048, 32, 8, 128)
    encoder = time_g(dev, 8, 1500, 20, 20, 64, causal=False)
    cross = time_g(dev, 4, 224, 20, 20, 64, sk=1500, causal=False)
    out = {"flash_attn": dict(zamba, per_shape=[zamba, gqa, encoder,
                                                cross])}
    bs, nc, cq, hh, p, n = 4, 8, 256, 64, 64, 64
    args = h_inputs((bs, nc, cq, hh, p, n), torch.bfloat16, dev, 98)
    tri = cq * (cq + 1) // 2
    rows = bs * nc * cq
    bms, bby = bound(2.0 * bs * nc * tri * (n + hh * p),
                     rows * (hh * p * 2 + hh * 4 + 2 * n * 2 + hh * p * 4)
                     + hh * 4, BF16_FLOPS)
    out["ssd_intra_chunk"] = {
        "shape": f"x ({bs}, {nc}, {cq}, {hh}, {p}) bf16, N {n}",
        "variant": kssd.variant_for(torch.bfloat16),
        "ms": cuda_ms(lambda: kssd.ssd_intra_chunk(*args)),
        "cuda_cores_ms": cuda_ms(lambda: kssd.ssd_intra_chunk(
            *args, variant="cuda_cores")),
        "plain_ms": cuda_ms(lambda: kssd.ssd_intra_chunk_plain(*args),
                            reps=5, warmup=1),
        "library_ms": cuda_ms(lambda: library_ssd(*args)),
        "library": "composite: torch.matmul C B^T + decay mask + "
                   "torch.matmul W X, float32",
        "bound_ms": bms, "bound_by": bby}
    for name, row in out.items():
        log(f"  {name}: {row}")
    return out


def fingerprint_ms(dev) -> dict:
    """The engine's content fingerprint of a build relation on the card:
    the pull of both columns to the host (``.cpu()``) and the SHA-1 over
    their bytes as ``relation_fingerprint`` takes them, each timed alone,
    and ``relation_fingerprint`` as one call."""
    import hashlib
    out = {}
    for n in FINGERPRINT_NS:
        rel = uniform_relation(n, seed=1, device=dev)
        eng.relation_fingerprint(rel, 0)                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        key, rid = rel.key.cpu().numpy(), rel.rid.cpu().numpy()
        t1 = time.perf_counter()
        h = hashlib.sha1()
        h.update(key.tobytes())
        h.update(rid.tobytes())
        h.hexdigest()
        t2 = time.perf_counter()
        eng.relation_fingerprint(rel, 0)
        t3 = time.perf_counter()
        out[n] = {"bytes": rel.nbytes, "pull_ms": (t1 - t0) * 1e3,
                  "hash_ms": (t2 - t1) * 1e3, "call_ms": (t3 - t2) * 1e3}
        log(f"  fingerprint n={n}: {rel.nbytes} B, pull "
            f"{out[n]['pull_ms']:.3f} ms, SHA-1 {out[n]['hash_ms']:.3f} ms,"
            f" relation_fingerprint {out[n]['call_ms']:.3f} ms")
    return out


def log_calibration(name: str, planner) -> dict:
    """A calibrated planner's measured specs: per-step unit costs per
    group, the PassPlanner's n1-n3 costs and the host hand-off."""
    pp = planner.pass_planner
    cal = {"u_ns_per_item": {k: [c * 1e9, g * 1e9] for k, (c, g)
                             in planner.u_overrides.items()},
           "pass_ns_per_item": {"C": [pp.u_n1 * 1e9, pp.u_n2 * 1e9,
                                      pp.u_n3 * 1e9],
                                "G": [pp.u_g[k] * 1e9
                                      for k in ("n1", "n2", "n3")]},
           "handoff_latency_s": planner.handoff_latency_s,
           "handoff_bytes_per_s": planner.handoff_bw_bytes_per_s}
    log(f"  {name}: unit costs, ns per item [C (host), G (card)]:")
    for k, (c, g) in cal["u_ns_per_item"].items():
        log(f"    {k}: C {c:.4f}, G {g:.4f}")
    for grp, (n1, n2, n3) in cal["pass_ns_per_item"].items():
        log(f"    PassPlanner {grp}: n1 {n1:.4f}, n2 {n2:.4f}, n3 {n3:.4f} "
            f"ns per item")
    log(f"    hand-off: latency {planner.handoff_latency_s * 1e6:.3f} us, "
        f"bandwidth {planner.handoff_bw_bytes_per_s / 1e9:.4f} GB/s")
    return cal


def run_engine(dev, phj_join_ms: float) -> dict:
    """Phase 11: the join-query engine on the card, through its entry
    points: ``QueryPlanner.calibrated``, then ``JoinQueryService`` serving
    the mixed workload with two workers, the paper's default query three
    times, a group-by, a semi and an anti join and a query under one
    injected kernel fault.  Every outcome is verified against a NumPy
    oracle; the launch counts are read over the service's runs."""
    t_phase = time.perf_counter()
    out = {"fingerprint": fingerprint_ms(dev)}
    cp = CoProcessor(c_device="cpu", g_device=dev)
    t0 = time.perf_counter()
    planner = eng.QueryPlanner.calibrated(cp, n=ENGINE_CAL_N, reps=2,
                                          delta=0.1)
    t1 = time.perf_counter()
    default = eng.QueryPlanner.calibrated(cp, reps=2, delta=0.1)
    log(f"  calibrated in {t1 - t0:.1f} s (n = {ENGINE_CAL_N}) and "
        f"{time.perf_counter() - t1:.1f} s (n = 32768, the default)")
    out["calibration"] = {ENGINE_CAL_N: log_calibration(
        f"n = {ENGINE_CAL_N}", planner),
        32768: log_calibration("n = 32768", default)}

    svc = eng.JoinQueryService(cp=cp, planner=planner, num_workers=2,
                               cache_budget_bytes=2 << 30)
    # Fingerprint time: the service's own content hashes, timed here.
    fp_s = [0.0]
    fingerprint = svc._fingerprint

    def timed_fingerprint(*a, **kw):
        t = time.perf_counter()
        try:
            return fingerprint(*a, **kw)
        finally:
            fp_s[0] += time.perf_counter() - t

    svc._fingerprint = timed_fingerprint
    qs = eng.make_workload("mixed", num_queries=ENGINE_QUERIES,
                           base_tuples=ENGINE_BASE, seed=42, device=dev)
    torch.cuda.synchronize()
    counts = {}

    def served(what: str, fn):
        torch.cuda.synchronize()
        rk.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        c = rk.launch_counts()
        log(f"  {what}: launches {c}")
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        return res

    t0 = time.perf_counter()
    outs = served("mixed workload", lambda: svc.run(qs))
    elapsed = time.perf_counter() - t0
    for q, o in zip(qs, outs):
        log(f"  q{q.query_id} {q.tag}: |R| {q.build.size}, |S| "
            f"{q.probe.size}, plan {o.plan.algorithm}/{o.plan.scheme}"
            f"{' cached' if o.plan.cached else ''}, cache hit "
            f"{o.cache_hit}, partition hit {o.partition_cache_hit}/"
            f"{o.probe_partition_cache_hit}, wall {o.wall_s * 1e3:.3f} ms, "
            f"queued {o.queued_s * 1e3:.3f} ms, phases {phase_ms(o.timing)}")
        assert o.wall_s >= sum(o.timing.phase_s.values()), q.query_id
        verify(o.result, join_oracle(q.build, q.probe),
               f"engine q{q.query_id} {q.tag}")
    st = svc.stats()
    ledger = st["host_transfer_ledger"]
    mixed = {"queries_per_s": len(qs) / elapsed, "elapsed_s": elapsed,
             "wall_ms": [o.wall_s * 1e3 for o in outs],
             "plans": [f"{o.plan.algorithm}/{o.plan.scheme}" for o in outs],
             "cache": st["cache"], "plan_counts":
                 st["planner"]["plan_counts"],
             "online": st["planner"]["online"],
             "fingerprint_bytes": ledger["by_cause"]["fingerprint"],
             "fingerprint_ms": fp_s[0] * 1e3}
    log(f"  mixed: {len(qs)} queries in {elapsed:.3f} s, "
        f"{mixed['queries_per_s']:.3f} queries/s; table cache hit rate "
        f"{st['cache']['hit_rate']:.3f} ({st['cache']['hits']} hits), "
        f"partition hits {st['cache']['partition_hits']}/"
        f"{st['cache']['probe_partition_hits']}")
    log(f"  plan counts {mixed['plan_counts']}; online scales "
        f"{mixed['online']}")
    log(f"  ledger: fingerprint {mixed['fingerprint_bytes']} B pulled, "
        f"{mixed['fingerprint_ms']:.3f} ms in the service's fingerprints")
    out["mixed"] = mixed

    # The paper's default query, through the service: cold, then the
    # repeats that find its build table or partition layouts resident.
    build = uniform_relation(N_MAIN, seed=1, device=dev)
    probe = uniform_relation(N_MAIN, seed=2, device=dev)
    exp = uniform_oracle(N_MAIN)
    runs = []
    for i in range(3):
        o = served(f"default query run {i}", lambda: svc.execute(
            eng.JoinQuery(build, probe, query_id=100 + i, tag="default")))
        log(f"  default query run {i}: plan {o.plan.algorithm}/"
            f"{o.plan.scheme}{' cached' if o.plan.cached else ''}, "
            f"schedule {o.plan.schedule}, ratios {o.plan.partition_ratio}"
            f"/{o.plan.join_ratio}, cache hit {o.cache_hit}, "
            f"partition hit {o.partition_cache_hit}/"
            f"{o.probe_partition_cache_hit}, wall {o.wall_s * 1e3:.3f} ms,"
            f" phases {phase_ms(o.timing)} (phj_join in phase 4: "
            f"{phj_join_ms:.3f} ms)")
        verify(o.result, exp, f"engine default query run {i}")
        runs.append({"plan": f"{o.plan.algorithm}/{o.plan.scheme}",
                     "cache_hit": o.cache_hit,
                     "partition_hit": [o.partition_cache_hit,
                                       o.probe_partition_cache_hit],
                     "wall_ms": o.wall_s * 1e3,
                     "phase_ms": phase_ms(o.timing)})
    out["default_query"] = runs

    keys, value_sets = group_data(N_MAIN, seed=N_MAIN)
    rel = Relation(torch.arange(N_MAIN, dtype=torch.int32, device=dev),
                   torch.from_numpy(keys).to(dev))
    vals = value_sets["full"]
    o = served("group-by", lambda: svc.execute(eng.GroupByQuery(
        rel, torch.from_numpy(vals).to(dev), query_id=200)))
    log(f"  group-by n={N_MAIN}: plan {o.plan.algorithm}/{o.plan.scheme},"
        f" schedule {o.plan.schedule}, wall {o.wall_s * 1e3:.3f} ms, "
        f"phases {phase_ms(o.timing)}")
    verify_groups(o.result, group_oracle(keys, vals), "engine group-by")
    out["groupby"] = {"plan": f"{o.plan.algorithm}/{o.plan.scheme}",
                      "wall_ms": o.wall_s * 1e3,
                      "phase_ms": phase_ms(o.timing)}

    vb = uniform_relation(N_DD, seed=1, device=dev)
    vp = uniform_relation(N_DD, seed=2, device=dev)
    for kind in ("semi", "anti"):
        o = served(f"{kind} join", lambda: svc.execute(eng.JoinQuery(
            vb, vp, query_id=300, tag=kind, kind=kind)))
        log(f"  {kind} n={N_DD}: plan {o.plan.algorithm}/{o.plan.scheme}"
            f"{' cached' if o.plan.cached else ''}, wall "
            f"{o.wall_s * 1e3:.3f} ms, phases {phase_ms(o.timing)}")
        verify(o.result, jv.join_variant_oracle(vb, vp, kind),
               f"engine {kind} join")
        out[kind] = {"wall_ms": o.wall_s * 1e3,
                     "plan": f"{o.plan.algorithm}/{o.plan.scheme}"}

    # One kernel fault on the worker path: the recovery ladder retries.
    fb = uniform_relation(N_DD, seed=5, device=dev)
    fpr = uniform_relation(N_DD, seed=6, device=dev)
    inj = eng.FaultInjector(seed=0, sites={"kernel": eng.FaultSpec(
        at=(1,))})
    with eng.injected(inj):
        o = served("fault-injected query", lambda: svc.submit(
            eng.JoinQuery(fb, fpr, query_id=400, tag="fault"))())
    events = [e["what"] for e in svc.metrics.events("recovery")]
    log(f"  fault-injected query: injector {inj.stats()}, recovery "
        f"{events}, plan {o.plan.algorithm}/{o.plan.scheme}, reference "
        f"path {bool(o.timing.notes.get('reference_path'))}, wall "
        f"{o.wall_s * 1e3:.3f} ms")
    assert inj.stats()["fired"] == {"kernel": 1} and events, events
    verify(o.result, join_oracle(fb, fpr), "engine fault-injected query")
    out["fault"] = {"recovery": events}
    svc.close()

    log(f"  engine launches {counts}")
    for name in ENGINE_KERNELS:
        assert counts.get(name, 0) > 0, f"the engine never launched {name}"
    out["launches"] = counts
    out["planner"] = planner
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 11 took {out['phase_s']:.1f} s")
    return out


# Phase 12, the multi-join query pipeline: examples/query_pipeline.py's
# star with the fact table at the paper's default 2^24 (§5.1) and the
# dimensions at benchmarks/query_bench.py's fact/8; the chain 2^24 -> 2^22
# -> 2^20; five analytic queries at WorkloadGenerator base 2^22; a six-star
# replay at base 2^21; the estimator-hostile skewed star at 2^22; the §3.3
# mechanisms at 2^24.
QP_FACT = N_MAIN
QP_DIMS = (1 << 21,) * 3
QP_CHAIN = (N_MAIN, 1 << 22, 1 << 20)
QP_ANALYTIC_BASE = 1 << 22
QP_ANALYTIC_N = 5
QP_REPLAY_BASE = 1 << 21
QP_REPLAY_N = 6
QP_SKEW_FACT = 1 << 22
QP_MECH_N = N_MAIN
QP_MECH_RATIOS = (0.25, 0.0, 0.5)   # n1, n2, n3: the boundary moves twice
PARTITION_KERNELS = ("partition_hist_fused", "radix_scatter", "radix_hist")


def skewed_star(fact: int, seed: int = 0):
    """The estimator-hostile 3-join star of benchmarks/query_bench.py's
    ``_skewed_star``, built on the port's query IR: ``fact.fk0`` is half
    junk, so the first join's estimate lands about 16x under its true
    cardinality, and the d2 edge (a shrink at the true intermediate size,
    a growth at the estimated one) flips which tail order is cheapest."""
    from repro_torch.queries import Join, Query, Table

    scale = max(1, fact // 8192)
    rng = np.random.default_rng(seed)
    d0_n, d1_n = 128 * scale, 144 * scale
    d2_distinct, d2_rep, fk2_range = 40 * scale, 10, 4000 * scale
    fk0 = np.where(rng.random(fact) < 0.5,
                   rng.integers(0, d0_n, fact),
                   rng.integers(10 * fact, 20 * fact, fact)).astype(np.int32)
    tables = {
        "fact": Table("fact", {
            "fk0": fk0,
            "fk1": rng.integers(0, d1_n, fact).astype(np.int32),
            "fk2": rng.integers(0, fk2_range, fact).astype(np.int32),
            "v": rng.integers(0, 100, fact).astype(np.int32)}),
        "d0": Table("d0", {"id": np.arange(d0_n, dtype=np.int32),
                           "a": rng.integers(0, 10, d0_n).astype(np.int32)}),
        "d1": Table("d1", {"id": np.arange(d1_n, dtype=np.int32),
                           "b": rng.integers(0, 10, d1_n).astype(np.int32)}),
        "d2": Table("d2", {
            "id": np.repeat(np.arange(d2_distinct, dtype=np.int32), d2_rep),
            "c": rng.integers(0, 10,
                              d2_distinct * d2_rep).astype(np.int32)})}
    return Query(tables=tables,
                 joins=(Join("fact", "fk0", "d0", "id"),
                        Join("fact", "fk1", "d1", "id"),
                        Join("fact", "fk2", "d2", "id")),
                 aggregate=("count",))


def verify_pipeline(res, ref, what: str) -> None:
    """Rows and aggregate equal to ``reference_execute``'s."""
    got = res.rows_array()
    assert got.shape == ref[0].shape and np.array_equal(got, ref[0]), what
    assert res.aggregate == ref[1], (what, res.aggregate, ref[1])
    log(f"  {what}: {res.rows} rows, aggregate {res.aggregate}, verified "
        f"against reference_execute")


def verify_chain(q, res, what: str) -> None:
    """The chain's oracle: every ``id`` is a permutation and every
    ``nxt`` lands in the next table, so each T0 row joins exactly one row
    of each later table, found through the inverse permutations.  Each
    result row is matched to its T0 row through ``T0.id`` (unique), and
    compared column by column."""
    names = sorted(q.tables)
    cols = [q.tables[t].columns for t in names]

    def inverse(ids):
        inv = np.empty_like(ids)
        inv[ids] = np.arange(ids.shape[0], dtype=ids.dtype)
        return inv

    got = res.columns
    want_names = sorted(f"{t}.{c}" for t, tcols in zip(names, cols)
                        for c in tcols)
    assert sorted(got) == want_names, (what, sorted(got))
    assert res.aggregate == res.rows == cols[0]["id"].shape[0], what
    rows = inverse(cols[0]["id"])[got[f"{names[0]}.id"]]   # T0 rows
    assert np.array_equal(np.sort(rows), np.arange(rows.shape[0])), what
    for i, (t, tcols) in enumerate(zip(names, cols)):
        if i:
            rows = inverse(tcols["id"])[cols[i - 1]["nxt"][rows]]
        for c, v in tcols.items():
            assert np.array_equal(got[f"{t}.{c}"], v[rows]), (what, t, c)
    log(f"  {what}: {res.rows} rows, verified against the chain's "
        f"permutation oracle")


def star_oracle(q):
    """``reference_execute`` for a star whose every edge runs from ``F``
    to a dimension's unique ``id`` (the generators' dimensions are
    permutations, and every foreign key lies within them): each fact row
    meets at most one row of each dimension, so inner and semi edges keep
    the fact rows whose key survives the dimension's filters, anti edges
    the others, and left-outer edges keep every row, NULL-padded.  Lookup
    tables replace the reference's sort-merge joins, and grouping is by
    sort and ``reduceat`` (``group_oracle``)."""
    from repro_torch import queries as tq

    f = q.tables["F"]
    assert not f.filters
    keep = np.ones(f.size, bool)
    attach = []
    for j in q.joins:
        d = q.tables[j.right]
        ids = d.columns["id"]
        assert (j.left, j.right_col) == ("F", "id")
        assert np.bincount(ids).max() <= 1, "dimension ids not unique"
        live = np.ones(d.size, bool)
        for flt in d.filters:
            live &= flt.mask(d.columns[flt.column])
        row = np.full(int(ids.max()) + 1, -1, np.int64)
        row[ids[live]] = np.flatnonzero(live)
        fk = f.columns[j.left_col]
        assert fk.min() >= 0 and fk.max() <= ids.max()
        r = row[fk]
        if j.kind in ("inner", "semi"):
            keep &= r >= 0
        elif j.kind == "anti":
            keep &= r < 0
        if j.kind in ("inner", "left_outer"):
            attach.append((d, r))
    cols = {f"F.{c}": v[keep] for c, v in f.columns.items()}
    for d, r in attach:
        r = r[keep]
        for c, v in d.columns.items():
            cols[f"{d.name}.{c}"] = np.where(r >= 0, v[np.maximum(r, 0)],
                                             np.int32(tq.NULL_VALUE))
    if not q.group_by:
        return tq.rows_array(cols), tq.apply_aggregate(cols, q.aggregate)
    (key_q,) = q.group_by
    agg = q.aggregate or ("count",)
    if cols[key_q].shape[0] == 0:
        return tq.rows_array(tq.apply_group_by(cols, q.group_by, agg)), None
    vals = (cols[agg[1]] if agg[0] != "count"
            else np.zeros(cols[key_q].shape[0], np.int32))
    k, cnt, sm, mn, mx = group_oracle(cols[key_q], vals)
    val = {"count": cnt.astype(np.int32), "sum": sm.astype(np.int64),
           "min": mn.astype(np.int32), "max": mx.astype(np.int32),
           "avg": sm.astype(np.float64) / np.maximum(cnt, 1)}[agg[0]]
    return tq.rows_array({key_q: k.astype(np.int32),
                          tq.agg_output_name(agg): val}), None


def stage_records(res) -> list[dict]:
    return [{"tag": o.tag,
             "plan": f"{o.plan.algorithm}/{o.plan.scheme}",
             "schedule": list(o.plan.schedule) if o.plan.schedule else None,
             "ratios": [o.plan.partition_ratio, o.plan.join_ratio],
             "cache_hit": o.cache_hit,
             "partition_hit": [o.partition_cache_hit,
                               o.probe_partition_cache_hit],
             "wall_ms": o.wall_s * 1e3, "phase_ms": phase_ms(o.timing),
             "host_bytes_moved": o.host_bytes_moved}
            for o in res.outcomes]


def run_query_pipeline(dev, planner) -> dict:
    """Phase 12: the multi-join query pipeline on the card through
    ``PipelineExecutor`` (``JoinQueryService``, two workers, phase 11's
    calibrated planner): the star cold and warm under the fused hand-off
    and once under the host hand-off, the chain, five analytic queries,
    a six-star replay and the skewed star static and adaptive, each exact
    against its oracle; then the §3.3 mechanisms.  The SHA-1 of base-table
    key columns (``_ScanView.col_fp``) and the exact match counts
    (``_match_stats``, synchronized around) are timed inside the runs."""
    import threading

    from repro_torch import queries as tq
    from repro_torch.queries import executor as qexec

    t_phase = time.perf_counter()
    out: dict = {}
    clocks = {"sha1_s": 0.0, "match_s": 0.0}
    lock = threading.Lock()
    orig_fp, orig_match = qexec._ScanView.col_fp, qexec._match_stats

    def timed_fp(self, q):
        t = time.perf_counter()
        try:
            return orig_fp(self, q)
        finally:
            with lock:
                clocks["sha1_s"] += time.perf_counter() - t

    def timed_match(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = orig_match(*a, **kw)
        int(r)
        with lock:
            clocks["match_s"] += time.perf_counter() - t
        return r

    qexec._ScanView.col_fp, qexec._match_stats = timed_fp, timed_match
    counts: dict = {}
    partitioned = []    # did any stage or sink run the partition passes?

    def served(what: str, svc, ex, q, physical=None):
        """One pipeline run with its launches counted, its clocks and
        ledger read before and after, the fused invariants checked."""
        fp0 = svc.ledger.by_cause()["fingerprint"]
        c0 = dict(clocks)
        torch.cuda.synchronize()
        rk.reset_launch_counts()
        res = ex.run(q, physical)
        torch.cuda.synchronize()
        c = rk.launch_counts()
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        partitioned.extend(bool(o.plan.schedule) for o in res.outcomes)
        rec = {"wall_ms": res.wall_s * 1e3, "rows": res.rows,
               "aggregate": res.aggregate, "stages": stage_records(res),
               "host_bytes_moved": res.host_bytes_moved,
               "fingerprint_bytes":
                   svc.ledger.by_cause()["fingerprint"] - fp0,
               "sha1_ms": (clocks["sha1_s"] - c0["sha1_s"]) * 1e3,
               "match_ms": (clocks["match_s"] - c0["match_s"]) * 1e3,
               "replans": res.replans, "launches": c}
        log(f"  {what}: wall {rec['wall_ms']:.3f} ms, host bytes "
            f"{rec['host_bytes_moved']}, fingerprint bytes "
            f"{rec['fingerprint_bytes']}, SHA-1 {rec['sha1_ms']:.3f} ms, "
            f"match counts {rec['match_ms']:.3f} ms, launches {c}")
        for s in rec["stages"]:
            log(f"    {s['tag']}: {s['plan']} schedule {s['schedule']} "
                f"ratios {s['ratios']}, cache hit {s['cache_hit']}, "
                f"partition hit {s['partition_hit']}, wall "
                f"{s['wall_ms']:.3f} ms, phases {s['phase_ms']}")
        assert res.wall_s >= sum(sum(o.timing.phase_s.values())
                                 for o in res.outcomes), what
        if ex.handoff == "device":
            assert rec["host_bytes_moved"] == 0, what
            assert rec["fingerprint_bytes"] == 0, what
        return res, rec

    cp = CoProcessor(c_device="cpu", g_device=dev)
    svc = eng.JoinQueryService(cp=cp, planner=planner, num_workers=2,
                               cache_budget_bytes=2 << 30)
    try:
        opt = tq.JoinOrderOptimizer(planner, handoff="device")
        ex = tq.PipelineExecutor(service=svc, optimizer=opt)

        # -- the star: chosen vs textual vs worst order, cold, warm, host.
        q = tq.make_star_query(QP_FACT, list(QP_DIMS),
                               selectivities=[0.02, None, 0.5], seed=17,
                               aggregate=("count",))
        t0 = time.perf_counter()
        ref = tq.reference_execute(q)
        log(f"  star {QP_FACT} x {list(QP_DIMS)}: oracle "
            f"{time.perf_counter() - t0:.1f} s on the host")
        t0 = time.perf_counter()
        chosen = opt.optimize(q)
        log(f"  optimize: {time.perf_counter() - t0:.3f} s on the host "
            f"(the first call counts each column's distinct values)")
        est = {"chosen": chosen, "textual": opt.price_order(q, q.joins),
               "worst": opt.worst_order(q)}
        for k, p in est.items():
            log(f"  {k} order {[str(j) for j in p.order]}: est "
                f"{p.est_total_s * 1e3:.3f} ms")
        star = {"est_ms": {k: p.est_total_s * 1e3 for k, p in est.items()},
                "orders": {k: [str(j) for j in p.order]
                           for k, p in est.items()}}
        for run in ("cold", "warm"):
            res, rec = served(f"star fused {run}", svc, ex, q, chosen)
            verify_pipeline(res, ref, f"star fused {run}")
            star[run] = rec
        host_ex = tq.PipelineExecutor(
            service=svc, handoff="host",
            optimizer=tq.JoinOrderOptimizer(planner, handoff="host"))
        res, rec = served("star host", svc, host_ex, q)
        verify_pipeline(res, ref, "star host")
        star["host"] = rec
        out["star"] = star

        log(f"  (star done at {time.perf_counter() - t_phase:.1f} s)")
        # -- the chain, and its largest stage's match count alone.
        qc = tq.make_chain_query(list(QP_CHAIN), seed=3)
        log(f"  (chain generated at {time.perf_counter() - t_phase:.1f} s)")
        res, rec = served("chain", svc, ex, qc)
        log(f"  (chain run at {time.perf_counter() - t_phase:.1f} s)")
        verify_chain(qc, res, "chain")
        bkey = torch.from_numpy(qc.tables["T1"].columns["id"]).to(dev)
        pkey = torch.from_numpy(qc.tables["T0"].columns["nxt"]).to(dev)
        assert int(orig_match(bkey, pkey, "inner")) == QP_CHAIN[0]
        rec["match_alone_ms"] = cuda_ms(
            lambda: orig_match(bkey, pkey, "inner"))
        log(f"  _match_stats alone, probe {QP_CHAIN[0]} x build "
            f"{QP_CHAIN[1]}: {rec['match_alone_ms']:.5f} ms (CUDA events)")
        out["chain"] = rec

        log(f"  (chain done at {time.perf_counter() - t_phase:.1f} s)")
        # -- analytic: the four edge-kind pairs, the five aggregates.
        gen = eng.WorkloadGenerator(QP_ANALYTIC_BASE, seed=42, device=dev)
        analytic = []
        for i in range(QP_ANALYTIC_N):
            qa = gen.analytic()
            kinds = [j.kind for j in qa.joins]
            t0 = time.perf_counter()
            rf = star_oracle(qa)
            log(f"  analytic {i}: fact {qa.tables['F'].size}, oracle "
                f"{time.perf_counter() - t0:.1f} s on the host")
            res, rec = served(f"analytic {i} {kinds} {qa.aggregate}", svc,
                              ex, qa)
            verify_pipeline(res, rf, f"analytic {i}")
            rec.update(kinds=kinds, aggregate_kind=list(qa.aggregate),
                       fact=qa.tables["F"].size)
            analytic.append(rec)
        assert len({tuple(a["kinds"]) for a in analytic}) == 4
        assert sum(a["launches"]["seg_agg"] for a in analytic) > 0
        out["analytic"] = analytic

        log(f"  (analytic done at {time.perf_counter() - t_phase:.1f} s)")
        # -- the star replay: a fresh service, two workers, one executor.
        rsvc = eng.JoinQueryService(cp=cp, planner=planner, num_workers=2,
                                    cache_budget_bytes=2 << 30)
        rex = tq.PipelineExecutor(service=rsvc, optimizer=opt)
        rgen = eng.WorkloadGenerator(QP_REPLAY_BASE, seed=29, device=dev)
        stars = [rgen.star() for _ in range(QP_REPLAY_N)]
        t0 = time.perf_counter()
        refs = [star_oracle(s) for s in stars]
        # The lookup oracle against the reference's own on the smallest.
        small = min(range(len(stars)), key=lambda i: stars[i].tables["F"].size)
        want = tq.reference_execute(stars[small])
        assert np.array_equal(refs[small][0], want[0]) and \
            refs[small][1] == want[1]
        log(f"  replay facts {[s.tables['F'].size for s in stars]}: oracles "
            f"{time.perf_counter() - t0:.1f} s on the host")
        replay = {"facts": [s.tables["F"].size for s in stars]}
        for i, (s, r) in enumerate(zip(stars, refs)):    # cold + verify
            res, _ = served(f"replay verify {i}", rsvc, rex, s)
            verify_pipeline(res, r, f"replay star {i}")
        t0 = time.perf_counter()
        timed = [served(f"replay {i}", rsvc, rex, s)[1]
                 for i, s in enumerate(stars)]
        elapsed = time.perf_counter() - t0
        st = rsvc.stats()
        replay.update(pipelines_per_s=len(stars) / elapsed,
                      elapsed_s=elapsed, cache=st["cache"],
                      wall_ms=[t["wall_ms"] for t in timed],
                      host_bytes_moved=st["host_bytes_moved"])
        assert st["host_bytes_moved"] == 0
        log(f"  replay: {len(stars)} pipelines in {elapsed:.3f} s, "
            f"{replay['pipelines_per_s']:.3f} pipelines/s; table hits "
            f"{st['cache']['hits']} (rate {st['cache']['hit_rate']:.3f}), "
            f"partition hits {st['cache']['partition_hits']}/"
            f"{st['cache']['probe_partition_hits']}")
        out["replay"] = replay

        log(f"  (replay done at {time.perf_counter() - t_phase:.1f} s)")
        # -- the skewed star, static then adaptive.
        qs = skewed_star(QP_SKEW_FACT, seed=41)
        rs = tq.reference_execute(qs)
        skew = {}
        for mode in ("static", "adaptive"):
            aex = tq.PipelineExecutor(service=rsvc, optimizer=opt,
                                      adaptive=mode == "adaptive")
            res, rec = served(f"skewed star {mode}", rsvc, aex, qs)
            verify_pipeline(res, rs, f"skewed star {mode}")
            rec["order"] = [str(s.join) for s in res.physical.stages]
            log(f"  skewed star {mode}: order {rec['order']}, replans "
                f"{res.replans}")
            skew[mode] = rec
        out["skewed"] = skew
        rsvc.close()
        log(f"  (skewed star done at {time.perf_counter() - t_phase:.1f} s)")
    finally:
        qexec._ScanView.col_fp, qexec._match_stats = orig_fp, orig_match
        svc.close()

    log(f"  query pipeline launches {counts}")
    for name in ("hash_bucket", "seg_agg"):
        assert counts.get(name, 0) > 0, f"the pipeline never launched {name}"
    for name in PARTITION_KERNELS:
        assert (counts.get(name, 0) > 0) == any(partitioned), (
            name, counts, any(partitioned))
    out["launches"] = counts
    out["sha1_alone"] = sha1_ms(q)
    out["mechanisms"] = run_paper_mechanisms(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 12 took {out['phase_s']:.1f} s")
    return out


def sha1_ms(q) -> dict:
    """SHA-1 of one 2^24-row int32 key column alone (``col_fp``'s bytes),
    and NumPy's bytes/s over it."""
    import hashlib
    col = q.tables["F"].columns["fk0"]
    t0 = time.perf_counter()
    hashlib.sha1(col.tobytes()).hexdigest()
    ms = (time.perf_counter() - t0) * 1e3
    log(f"  SHA-1 of F.fk0 ({col.nbytes} B): {ms:.3f} ms, "
        f"{col.nbytes / ms / 1e6:.3f} GB/s")
    return {"bytes": col.nbytes, "ms": ms}


def run_paper_mechanisms(dev) -> dict:
    """The §3.3 mechanisms at 2^24 on the card: divergence grouping of the
    p2 key counts of a skewed SHJ probe, the scan allocator against a
    NumPy oracle, and ``run_map_series`` over ``partition_series(0)``
    with the C group on the host and a ratio that moves, bit-equal to
    one-device ``run_series`` over each group's slice."""
    from repro_torch.core import (alloc_stats, basic_alloc_units,
                                  build_hash_table, default_num_buckets,
                                  divergence_order, inverse_permutation,
                                  partition_series, scan_alloc,
                                  skewed_relation, tile_divergence_waste)
    from repro_torch.core import hash_table as ht
    from repro_torch.core.steps import run_series

    n = QP_MECH_N
    out: dict = {}
    # Divergence: the p2 key counts of a 25 %-skewed probe.
    nb = default_num_buckets(n)
    table = build_hash_table(skewed_relation(n, s_percent=25, seed=1,
                                             device=dev), nb)
    probe = skewed_relation(n, s_percent=25, seed=2, device=dev)
    _, w = ht.probe_p2(table, ht.probe_p1(probe.key, nb))
    w_np = w.cpu().numpy().astype(np.int64)

    def waste_np(x):
        pad = (-x.shape[0]) % 256
        t = np.pad(x.astype(np.float64), (0, pad)).reshape(-1, 256)
        return 1.0 - t.sum() / max(t.max(axis=1).sum() * 256, 1e-9)

    before = float(tile_divergence_waste(w, 256))
    assert abs(before - waste_np(w_np)) <= 1e-5 * max(1.0, before)
    div = {"waste_before": before, "after": {}}
    for groups in (8, 64, 512):
        order = divergence_order(w, groups)
        g_np = np.minimum(w_np * groups // (max(w_np.max(), 1) + 1),
                          groups - 1)
        assert np.array_equal(order.cpu().numpy(),
                              np.argsort(g_np, kind="stable")), groups
        inv = inverse_permutation(order)
        assert torch.equal(order[inv.long()],
                           torch.arange(n, dtype=torch.int32, device=dev))
        after = float(tile_divergence_waste(w[order.long()], 256))
        assert abs(after - waste_np(w_np[order.cpu().numpy()])) <= \
            1e-5 * max(1.0, after)
        div["after"][groups] = {
            "waste": after,
            "order_ms": cuda_ms(lambda: divergence_order(w, groups))}
    log(f"  divergence over p2 key counts (n={n}, mean "
        f"{w_np.mean():.3f}, max {w_np.max()}): waste {before:.4f} before,"
        f" after {div['after']}")
    out["divergence"] = div

    # The scan allocator at 2^24 request sizes (alloc_figs' sizes).
    sizes_np = np.random.default_rng(0).integers(0, 8, n, dtype=np.int32)
    sizes = torch.from_numpy(sizes_np).to(dev)
    alloc = {"basic_units": basic_alloc_units(sizes), "blocks": {}}
    for block in (32, 256, 2048):
        offs, total = scan_alloc(sizes, tile=256, block_items=block)
        s = sizes_np.astype(np.int64).reshape(-1, 256)
        local = np.cumsum(s, axis=1) - s
        need = s.sum(axis=1)
        claim = (need + block - 1) // block * block
        base = np.cumsum(claim) - claim
        want = (base[:, None] + local).reshape(-1)
        got = offs.cpu().numpy().astype(np.int64)
        assert np.array_equal(got, want) and int(total) == claim.sum()
        ends = got + sizes_np
        inner = np.arange(1, n) % 256 != 0
        assert (got[1:][inner] == ends[:-1][inner]).all()
        assert (got[::256] >= np.r_[0, ends.reshape(-1, 256).max(
            axis=1)[:-1]]).all()                        # no overlap
        st = alloc_stats(sizes, tile=256, block_items=block)
        assert st.global_units == n // 256 < alloc["basic_units"]
        alloc["blocks"][block] = {
            "ms": cuda_ms(lambda: scan_alloc(sizes, tile=256,
                                             block_items=block)),
            "global_units": st.global_units,
            "fragmentation": st.fragmentation}
    log(f"  scan_alloc at n={n}: {alloc}")
    out["alloc"] = alloc

    # run_map_series: C on the host, G on the card, the ratio moving.
    rng = np.random.default_rng(7)
    items = {"rid": torch.from_numpy(rng.permutation(n).astype(np.int32)),
             "key": torch.from_numpy(rng.integers(0, 2**31 - 1, n)
                                     .astype(np.int32))}
    shared = {"shift": 0, "bits": 7}
    series = partition_series(0)
    cp = CoProcessor(c_device="cpu", g_device=dev)
    cp.run_map_series(series, shared, items, QP_MECH_RATIOS)   # warm-up
    torch.cuda.synchronize()
    rk.reset_launch_counts()
    t0 = time.perf_counter()
    ic, ig, extra, timing = cp.run_map_series(series, shared, items,
                                              QP_MECH_RATIOS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rk.launch_counts()
    cut0, cut = cp._cut(n, QP_MECH_RATIOS[0]), cp._cut(n, QP_MECH_RATIOS[-1])
    for lo, hi, got in ((0, cut, ic), (cut, n, ig)):
        want, _ = run_series(series, shared,
                             {k: v[lo:hi] for k, v in items.items()})
        for k in ("rid", "key"):
            assert torch.equal(got[k].cpu(), want[k]), (lo, k)
    _, whole = run_series(series, shared, items)
    assert torch.equal(extra["part_hist"].cpu(), whole["part_hist"])
    dev_items = {k: v.to(dev) for k, v in items.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_series(series, shared, dev_items)
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    crossed = 8 * (n - cut0) + timing.transfer_bytes
    out["map_series"] = {"ratios": list(QP_MECH_RATIOS), "wall_ms":
                         wall * 1e3, "emulated_bytes": timing.transfer_bytes,
                         "bytes_crossed": crossed,
                         "gpu_only_ms": one * 1e3, "launches": launches}
    log(f"  run_map_series n={n} ratios {QP_MECH_RATIOS}: wall "
        f"{wall * 1e3:.3f} ms, Timing.transfer_bytes "
        f"{timing.transfer_bytes} (the boundary moves), bytes across the "
        f"bus {crossed} (with the initial G slice); one-device run_series "
        f"on the card {one * 1e3:.3f} ms; launches {launches}; items "
        f"bit-equal to run_series over each group's slice")
    assert launches["hash_bucket"] == 1 and launches["radix_hist"] == 1
    out["launches"] = launches
    return out


@torch.no_grad()
def plain_xent(params, cfg, batch, micro: int) -> float:
    """The mean over ``batch``'s microbatches of plain cross-entropy over
    ``forward_train``'s whole logits (the real vocabulary)."""
    out = []
    for i in range(0, batch["tokens"].shape[0], micro):
        logits, _ = tfm.forward_train(params, cfg,
                                      batch["tokens"][i:i + micro])
        out.append(float(torch.nn.functional.cross_entropy(
            logits[..., :cfg.vocab_size].float().flatten(0, 1),
            batch["labels"][i:i + micro].long().flatten())))
        del logits
    return float(np.mean(out))


@contextlib.contextmanager
def plain_lm_kernels():
    """G and H replaced in the layers by their plain versions, forward and
    backward by autograd (no kernel launches)."""
    g, h = lattn.flash_attention, lssd.ssd_intra_chunk
    lattn.flash_attention, lssd.ssd_intra_chunk = (flash_attention_ref,
                                                   ssd_intra_chunk_ref)
    try:
        yield
    finally:
        lattn.flash_attention, lssd.ssd_intra_chunk = g, h


def microbatch_grads(params, cfg, batch) -> tuple[float, list]:
    """One microbatch's loss and every leaf's gradient."""
    m, grads = loss_and_grads(params, cfg, batch,
                              tree_leaves(param_tree(params)))
    return float(m["loss"]), grads


@contextlib.contextmanager
def diluted_g(lo: int, hi: int):
    """Kernel G with keys and values ``[lo, hi)`` zeroed wherever the
    keys reach ``hi``: a known fault (a key tile past 2048 lost) that the
    gradient check must catch."""
    real = fa.flash_attention

    def faulty(q, k, v, **kw):
        if k.shape[1] >= hi:
            k, v = k.clone(), v.clone()
            k[:, lo:hi] = 0
            v[:, lo:hi] = 0
        return real(q, k, v, **kw)

    fa.flash_attention = faulty
    try:
        yield
    finally:
        fa.flash_attention = real


def kernel_grads(params, cfg, batch, n_g: int, n_h: int):
    """One microbatch's (loss, gradient) through G and H, which must
    launch ``n_g`` and ``n_h`` times."""
    rk.reset_launch_counts()
    out = microbatch_grads(params, cfg, batch)
    counts = rk.launch_counts()
    assert counts["flash_attn"] == n_g and \
        counts["ssd_intra_chunk"] == n_h, counts
    return out


def plain_grads(params, cfg, batch):
    """The same through G's and H's plain versions, which launch
    nothing."""
    rk.reset_launch_counts()
    with plain_lm_kernels():
        out = microbatch_grads(params, cfg, batch)
    assert not any(rk.launch_counts().values()), rk.launch_counts()
    return out


def leaf_rel(names, got, want) -> tuple[dict, float]:
    """Each leaf's RMS(got - want) / RMS(want), and the whole gradient's."""
    leaf, num, den = {}, 0.0, 0.0
    for name, a, b in zip(names, got, want):
        a, b = a.float(), b.float()
        d2, w2 = float((a - b).square().sum()), float(b.square().sum())
        num, den = num + d2, den + w2
        leaf[name] = math.sqrt(d2 / max(w2, 1e-30))
    return leaf, math.sqrt(num / den)


def worst(d: dict, n: int = 3) -> list:
    return sorted(d.items(), key=lambda kv: -kv[1])[:n]


def by_kind(leaf: dict, names: list) -> dict:
    """The largest of ``leaf`` over each kind of leaf among ``names``
    (the path past the unit's index: "5A/attn/wq")."""
    out = {}
    for n in names:
        kind = n.split("/", 2)[-1]
        out[kind] = max(out.get(kind, 0.0), leaf[n])
    return out


def grad_readings(names, attn, proj, k16, k32, p16, p32) -> dict:
    """The gradient check's readings from the (loss, gradient) pairs
    through the kernels (``k16``, ``k32``) and through the plain versions
    (``p16``, ``p32``) in bfloat16 and float32."""
    leaf, whole = leaf_rel(names, k16[1], p16[1])
    leaf32, whole32 = leaf_rel(names, k32[1], p32[1])
    noise, noise_whole = leaf_rel(names, p16[1], p32[1])
    kern, kern_whole = leaf_rel(names, k16[1], p32[1])
    return {
        "bf16": {"loss": k16[0], "loss_rel": abs(k16[0] - p16[0]) / p16[0],
                 "whole_rel": whole,
                 "median_leaf_rel": float(np.median(list(leaf.values()))),
                 "attn_proj_rel": max(leaf[n] for n in proj),
                 "worst_leaves": worst(leaf),
                 "attn_by_kind": by_kind(leaf, attn)},
        "f32": {"loss": k32[0], "loss_rel": abs(k32[0] - p32[0]) / p32[0],
                "whole_rel": whole32,
                "median_leaf_rel": float(np.median(list(leaf32.values()))),
                "worst_leaf_rel": max(leaf32.values()),
                "worst_leaves": worst(leaf32)},
        "bf16_vs_f32": {"plain_whole": noise_whole,
                        "kernel_whole": kern_whole,
                        "whole_ratio": kern_whole / noise_whole,
                        "plain_worst": worst(noise),
                        "kernel_worst": worst(kern),
                        "worst_ratio": max(kern.values())
                        / max(noise.values()),
                        "plain_attn_by_kind": by_kind(noise, attn)}}


def limits_broken(r: dict) -> set:
    """The gradient check's limits that readings ``r`` break."""
    b16, f32, c = r["bf16"], r["f32"], r["bf16_vs_f32"]
    return {name for name, value, limit in (
        ("loss", b16["loss_rel"], TRAIN_LOSS_REL),
        ("whole", b16["whole_rel"], TRAIN_WHOLE_REL),
        ("median leaf", b16["median_leaf_rel"], TRAIN_MEDIAN_LEAF_REL),
        ("attention projection", b16["attn_proj_rel"], TRAIN_ATTN_PROJ_REL),
        ("f32 loss", f32["loss_rel"], TRAIN_F32_LOSS_REL),
        ("f32 leaf", f32["worst_leaf_rel"], TRAIN_F32_LEAF_REL),
        ("whole ratio", c["whole_ratio"], TRAIN_BF16_WHOLE_RATIO),
        ("worst ratio", c["worst_ratio"], TRAIN_BF16_WORST_RATIO))
        if not value < limit}


def log_grad_readings(what: str, r: dict) -> None:
    b16, f32, c = r["bf16"], r["f32"], r["bf16_vs_f32"]
    log(f"  {what}, through G and H vs their plain versions: bf16 loss rel "
        f"{b16['loss_rel']:.3g}, whole {b16['whole_rel']:.4g}, median leaf "
        f"{b16['median_leaf_rel']:.4g}, worst attention projection "
        f"{b16['attn_proj_rel']:.4g}, worst leaves {b16['worst_leaves']}; "
        f"f32 loss rel {f32['loss_rel']:.3g}, whole {f32['whole_rel']:.4g}"
        f", median leaf {f32['median_leaf_rel']:.4g}, worst leaves "
        f"{f32['worst_leaves']}")
    log(f"  {what}, bf16 against the plain f32 gradient: whole plain "
        f"{c['plain_whole']:.4g}, through G and H {c['kernel_whole']:.4g} "
        f"(ratio {c['whole_ratio']:.4f}); worst leaves plain "
        f"{c['plain_worst']}, through G and H {c['kernel_worst']} (ratio "
        f"{c['worst_ratio']:.4f})")
    log(f"  {what}, attention blocks' leaves by kind, the largest of the "
        f"six: bf16 through G and H vs plain {b16['attn_by_kind']}; plain "
        f"bf16 vs plain f32 {c['plain_attn_by_kind']}; limits broken "
        f"{sorted(limits_broken(r))}")


def check_train_grads(params, cfg, micros: list, n_g: int,
                      n_h: int) -> dict:
    """The gradient through G and H (and their plain backward) against
    the one through their plain versions alone, on the card, on each of
    ``micros``: in bfloat16, in float32 at the same weights, and each
    bfloat16 gradient's distance from the plain float32 one (plain
    bfloat16's own is bfloat16's rounding).  On the first microbatch the
    same through a G with a key tile past 2048 lost (``diluted_g``), which
    must break every limit in ``TRAIN_FAULT_BREAKS``."""
    names = list(flatten_with_paths(param_tree(params)))
    attn = [n for n in names if re.search(r"/\d+A/", n)]
    proj = [n for n in attn if re.search(r"/attn/w[qkvo]$", n)]
    assert len(proj) == 4 * (cfg.pattern_unit * cfg.num_units).count("A")
    p32 = copy.deepcopy(params).float()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out = {"sound": []}
    for j, batch in enumerate(micros):
        plain = (plain_grads(params, cfg, batch),
                 plain_grads(p32, cfg32, batch))
        r = grad_readings(names, attn, proj,
                          kernel_grads(params, cfg, batch, n_g, n_h),
                          kernel_grads(p32, cfg32, batch, n_g, n_h), *plain)
        out["sound"].append(r)
        log_grad_readings(f"microbatch {j} "
                          f"{tuple(batch['tokens'].shape)}", r)
        if j == 0:
            with diluted_g(*TRAIN_FAULT_KEYS):
                out["fault"] = grad_readings(
                    names, attn, proj,
                    kernel_grads(params, cfg, batch, n_g, n_h),
                    kernel_grads(p32, cfg32, batch, n_g, n_h), *plain)
            log_grad_readings(f"microbatch 0 through G with keys "
                              f"{list(TRAIN_FAULT_KEYS)} lost (the fault "
                              f"control)", out["fault"])
        del plain
    del p32
    for r in out["sound"]:
        assert not limits_broken(r), (limits_broken(r), r)
    assert TRAIN_FAULT_BREAKS <= limits_broken(out["fault"]), out["fault"]
    return out


def time_train_backward(dev, micro: int, seq: int, cfg) -> dict:
    """G's and H's plain backward alone at the training shapes, beside the
    forward kernel's time on the same inputs (CUDA events)."""
    h, d = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = g_inputs((micro, seq, seq, h, h, d, True), torch.bfloat16,
                       dev, 97)
    go = torch.randn_like(q)
    s = cfg.ssm
    nh = s.expand * cfg.d_model // s.head_dim
    shape = (micro, seq // s.chunk, s.chunk, nh, s.head_dim, s.d_state)
    args = h_inputs(shape, torch.bfloat16, dev, 96)
    gy = torch.randn(shape[:5], device=dev)
    out = {
        "flash_attn": {
            "shape": f"q/k/v ({micro}, {seq}, {h}, {d}) bf16, causal",
            "ms": cuda_ms(lambda: fa.flash_attention(
                q, k, v, num_kv_heads=h, causal=True), reps=5),
            "backward_plain_ms": cuda_ms(lambda: gops.flash_attention_bwd(
                q, k, v, go, num_kv_heads=h, causal=True), reps=3,
                warmup=1)},
        "ssd_intra_chunk": {
            "shape": f"x {shape[:5]} bf16, N {s.d_state}",
            "ms": cuda_ms(lambda: kssd.ssd_intra_chunk(*args), reps=5),
            "backward_plain_ms": cuda_ms(lambda: hops.ssd_intra_chunk_bwd(
                *args, gy), reps=3, warmup=1)}}
    for name, row in out.items():
        log(f"  {name} at the training shape: {row}")
    return out


def check_resume_in_child() -> dict:
    """``check_resume`` in a child process of this script that sets
    ``CUBLAS_WORKSPACE_CONFIG`` (cuBLAS reads it once, when it starts), so
    every other phase runs with PyTorch's default cuBLAS workspace.  The
    child's log lines pass through; its last line is the result."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        RESUME_FLAG], env=env, capture_output=True,
                       text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if r.returncode != 0:
        log(r.stdout[-4000:])
        raise RuntimeError(f"resume check failed ({r.returncode}):\n"
                           f"{r.stderr[-8000:]}")
    return json.loads(lines[-1])


def check_resume(dev) -> dict:
    """tests/test_checkpoint.py's resume check on the card at
    reduced(zamba2_1_2b): 2 steps against 1 step, save, restore, 1 more,
    bit for bit; then the CLI twice with the same flags, the second run
    resuming from the first one's step-4 checkpoint and ending on its
    loss.  Both under torch.use_deterministic_algorithms."""
    cfg = reduced(get_config(TRAIN_ARCH))
    b, s = TRAIN_SMALL_SHAPE
    shape = ShapeSpec("t", s, b, "train")
    opt = AdamWConfig(lr=TRAIN_LR)
    step = make_train_step(cfg, opt)

    def fresh():
        lm = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        return lm, adamw_init(lm, opt)

    torch.use_deterministic_algorithms(True)
    try:
        rk.reset_launch_counts()
        pa, sa = fresh()
        for i in range(2):
            pa, sa, _ = step(pa, sa, make_batch(cfg, shape, i, device=dev))
        counts = rk.launch_counts()
        pb, sb = fresh()
        pb, sb, _ = step(pb, sb, make_batch(cfg, shape, 0, device=dev))
        with tempfile.TemporaryDirectory() as tmp:
            save_checkpoint(tmp, 1, {"params": param_tree(pb), "opt": sb})
            pc, sc = fresh()
            restore_checkpoint(tmp, 1, {"params": param_tree(pc),
                                        "opt": sc})     # in place
        pc, sc, _ = step(pc, sc, make_batch(cfg, shape, 1, device=dev))
        pairs = list(zip(tree_leaves([param_tree(pa), sa]),
                         tree_leaves([param_tree(pc), sc])))
        differ = sum(not torch.equal(x, y) for x, y in pairs)
        log(f"  resume at {cfg.name}: {len(pairs)} leaves, {differ} differ "
            f"(bit for bit); launches in 2 steps {counts}")
        assert differ == 0 and counts["flash_attn"] > 0 and \
            counts["ssd_intra_chunk"] > 0, (differ, counts)
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--arch", TRAIN_ARCH, "--smoke", "--device", dev.type,
                    "--steps", "6",
                    "--ckpt-dir", tmp, "--ckpt-every", "4",
                    "--log-every", "1"]
            first = launch_train.main(argv)
            second = launch_train.main(argv)
        log(f"  launch.train twice: first {first}, second {second}")
        assert first["start"] == 0 and second["start"] == 4, (first, second)
        assert all(first[k] == second[k] for k in ("loss", "grad_norm",
                                                   "lr")), (first, second)
    finally:
        torch.use_deterministic_algorithms(False)
    return {"leaves": len(pairs), "differ": differ, "cli_first": first,
            "cli_second": second}


def run_training(dev, cfg) -> dict:
    """Phase 15: ``cfg`` (TRAIN_ARCH at full width and depth in the run of
    ``main``) through
    ``make_train_step``: ``TRAIN_STEPS`` steps of SyntheticLM data at
    ``TRAIN_SEQ`` tokens a sequence, two microbatches of 2 a step and one
    at the end; per step its time, tokens/s, loss, gradient norm, lr, G
    and H launches by variant and peak memory; the gradient against the
    plain versions' on one microbatch; G's and H's plain backward timed
    alone; then the resume check and the CLI at the reduced config."""
    layers = cfg.pattern_unit * cfg.num_units
    n_attn = layers.count("A")
    n_unit_m, n_tail_m = layers.count("M"), cfg.tail.count("M")
    # Per microbatch: each unit's blocks forward and again in its
    # recompute (remat "full"), the tail's once.
    per_micro = {"flash_attn": 2 * n_attn,
                 "ssd_intra_chunk": 2 * n_unit_m + n_tail_m}
    params, n_params = init_lm(cfg, dev)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=min(20, TRAIN_STEPS // 5),
                      total_steps=TRAIN_STEPS)
    state = adamw_init(params, opt)
    ds = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    steps = {a: make_train_step(cfg, opt, accum_steps=a)
             for a in (TRAIN_ACCUM, 1)}
    micro = TRAIN_BATCH // TRAIN_ACCUM
    rows = []
    for i in range(TRAIN_STEPS):
        accum = TRAIN_ACCUM if i < TRAIN_STEPS - 1 else 1
        b = micro * accum
        batch = {k: torch.from_numpy(v[:b]).to(dev)
                 for k, v in ds.batch(i).items()}
        if i == 0:
            loss0 = plain_xent(params, cfg, batch, micro)
        rk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = steps[accum](params, state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = rk.launch_counts()
        row = {"step": i, "accum": accum, "batch": b, "ms": ms,
               "tokens_per_s": b * TRAIN_SEQ / ms * 1e3,
               **{k: float(v) for k, v in m.items()},
               "launches": counts,
               "flash_attn_variants": dict(fa.launches_by_variant),
               "ssd_intra_chunk_variants": dict(kssd.launches_by_variant),
               "peak_bytes": torch.cuda.max_memory_allocated()}
        log(f"  step {i}{' (first: warm-up)' if i == 0 else ''}: accum "
            f"{accum} x {micro} x {TRAIN_SEQ}, {ms:.3f} ms, "
            f"{row['tokens_per_s']:.1f} tok/s, loss {row['loss']:.6f}, "
            f"grad_norm {row['grad_norm']:.6f}, lr {row['lr']:.3g}, "
            f"launches {counts}, G {row['flash_attn_variants']}, H "
            f"{row['ssd_intra_chunk_variants']}, peak "
            f"{row['peak_bytes'] / 2**30:.2f} GiB")
        assert math.isfinite(row["loss"]) and \
            math.isfinite(row["grad_norm"]), row
        for name, n in per_micro.items():
            assert counts[name] == accum * n, (name, counts)
        assert row["flash_attn_variants"]["wgmma"] == counts["flash_attn"]
        assert row["ssd_intra_chunk_variants"]["wgmma"] == \
            counts["ssd_intra_chunk"]
        assert sum(counts.values()) == accum * sum(per_micro.values())
        rows.append(row)
    rel0 = abs(rows[0]["loss"] - loss0) / loss0
    log(f"  step 0 loss {rows[0]['loss']:.6f}; plain cross-entropy over "
        f"forward_train's logits {loss0:.6f} (rel {rel0:.3g}, limit "
        f"{TRAIN_LOSS0_REL}; ln V is {math.log(cfg.vocab_size):.4f})")
    assert rel0 < TRAIN_LOSS0_REL, (rows[0]["loss"], loss0)
    del state, m
    free_card()
    micros = [{k: torch.from_numpy(v[j:j + micro]).to(dev)
               for k, v in ds.batch(0).items()} for j in (0, micro)]
    grads = check_train_grads(params, cfg, micros, per_micro["flash_attn"],
                              per_micro["ssd_intra_chunk"])
    del params, micros
    free_card()
    times = time_train_backward(dev, micro, TRAIN_SEQ, cfg)
    steady = [r for r in rows[1:] if r["accum"] == TRAIN_ACCUM]
    step_ms = float(np.median([r["ms"] for r in steady]))
    bwd_ms = TRAIN_ACCUM * (
        n_attn * times["flash_attn"]["backward_plain_ms"]
        + (n_unit_m + n_tail_m) * times["ssd_intra_chunk"][
            "backward_plain_ms"])
    log(f"  steady step ({TRAIN_ACCUM} x {micro} x {TRAIN_SEQ}): median "
        f"{step_ms:.3f} ms; G's and H's plain backward about {bwd_ms:.3f} "
        f"ms of it ({bwd_ms / step_ms:.3f})")
    free_card()
    resume = check_resume_in_child()
    return {"arch": cfg.name, "params": n_params, "seq": TRAIN_SEQ,
            "steps": rows, "loss0_plain": loss0, "steady_step_ms": step_ms,
            "launches": steady[-1]["launches"], "grad_check": grads,
            "kernel_times": times, "plain_backward_ms": bwd_ms,
            "plain_backward_share": bwd_ms / step_ms, "resume": resume}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    if sys.argv[1:] == [RESUME_FLAG]:       # phase 15's child process
        print(json.dumps(check_resume(dev)))
        return 0
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] setup: {smi} | {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s")

    log_phase("[2-3] kernels A-F against their plain versions (bit-exact)")
    err = check_kernels(dev)
    err.update(check_group_kernels(dev))
    err.update(check_probe_kernel(dev))
    for extra in (check_wide_kernels(dev), check_clustered_hist(dev)):
        for name, e in extra.items():
            err[name] = max(err[name], e)
    run_wide_joins(dev)

    log_phase("[4] main path: phj_join 2^24 x 2^24")
    main_path = run_main_path(dev)

    log_phase("[5] CoProcessor.phj")
    run_coprocessor(dev)

    log_phase("[5b] main path: CoProcessor.groupby")
    groupby = run_groupby(dev)

    log_phase("[7] main path: partitioned probe join 2^24 x 2^24")
    probe_join = run_probe_join(dev)
    err["partitioned_probe"] = max(err["partitioned_probe"],
                                   check_wide_probe(dev)["partitioned_probe"])

    log_phase("[8] main path: co-processed SHJ and join variants")
    shj = run_shj(dev)

    log_phase("[9] kernels G and H against their plain versions")
    err.update(check_lm_kernels(dev))

    log_phase(f"[10] main path: LM serving, {LM_ARCH} at full width")
    cfg = get_config(LM_ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff,
            cfg.dtype) == (38, 2048, 32, 8192, "bfloat16"), cfg
    lm = run_lm_serving(dev, cfg)

    log_phase("[11] main path: the join-query engine")
    engine = run_engine(dev, main_path["wall_ms"])

    log_phase("[12] main path: the multi-join query pipeline")
    pipeline = run_query_pipeline(dev, engine["planner"])

    log_phase(f"[13] main path: MoE serving, {MOE_ARCH} at full width, "
              "dense and sorted dispatch")
    moe = run_moe_serving(dev)

    log_phase(f"[14] main path: encoder-decoder serving, {ENCDEC_ARCH} at "
              "full width")
    free_card()
    encdec = run_encdec_serving(dev)

    log_phase(f"[15] main path: training {TRAIN_ARCH} at full width, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step")
    free_card()
    cfg = get_config(TRAIN_ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.dtype, cfg.remat) == \
        (38, 2048, "bfloat16", "full"), cfg
    training = run_training(dev, cfg)
    free_card()

    log_phase("[6] kernel times at the main paths' shapes")
    times = time_kernels(dev, main_path["schedule"])
    other_times = time_group_kernels(dev)
    other_times["radix_hist"]["per_input"] += time_router_hist(
        moe["router_pids"], moe["router_parts"])
    other_times.update(time_probe_kernel(dev))
    other_times.update(time_lm_kernels(dev))

    # Launches: A and B from phj_join (slice 1's path), C, D and E from
    # the GPU_ONLY partitioned group-by at 2^24, the path that added them,
    # F from the partitioned probe join.
    by_path = {"phj_join": main_path["launches"],
               "groupby_gpu_only_partitioned":
                   groupby["GPU_ONLY_PART/full"]["launches"],
               "partitioned_probe_join": probe_join["launches"],
               "shj_gpu_only":
                   shj[f"shj GPU_ONLY shared n={N_MAIN}"]["launches"],
               "lm_generate": next(iter(lm["batches"].values()))[
                   "launches"],
               "engine_service": engine["launches"],
               "query_pipeline": pipeline["launches"],
               "paper_mechanisms": pipeline["mechanisms"]["launches"],
               **{f"moe_generate_{impl}": moe["served"][
                   f"{impl} {LM_BATCHES[0][0]} x {LM_BATCHES[0][1]} + "
                   f"{LM_BATCHES[0][2]}"]["launches"]
                  for impl in MOE_ENGINES},
               "encdec_generate": next(iter(encdec["served"].values()))[
                   "launches"],
               "train_step": training["launches"]}
    path_of = {"seg_agg": "groupby_gpu_only_partitioned",
               "hash_bucket": "groupby_gpu_only_partitioned",
               "radix_hist": "groupby_gpu_only_partitioned",
               "partitioned_probe": "partitioned_probe_join",
               "flash_attn": "lm_generate", "ssd_intra_chunk": "lm_generate"}
    record = []
    for name, meta in KERNELS.items():
        if name in times:
            first = times[name][0]
            row = {k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "library_ms")}
            row["per_pass"] = times[name]
            path = "phj_join"
        else:
            row = other_times[name]
            path = path_of[name]
        if name in ("flash_attn", "ssd_intra_chunk"):
            row["launches_by_variant"] = next(iter(lm["batches"].values()))[
                f"{name}_variants"]
            row["train"] = training["kernel_times"][name]
        record.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": by_path[path][name], "launches_path": path,
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in by_path.items()},
            "max_abs_err": err[name], "bit_exact": err[name] == 0,
            "bound_by": "bytes", **row})
    for b in lm["batches"].values():
        log(f"  LM {b['batch']} x {b['prompt']} + {b['new']}: prefill "
            f"{b['prefill_ms']:.3f} ms, decode {b['decode_ms_per_step']:.3f}"
            f" ms/step, {b['tokens_per_s']:.1f} tok/s, peak "
            f"{b['peak_bytes'] / 2**30:.2f} GiB")
    for what, r in moe["served"].items():
        log(f"  MoE {what}: generate {r['generate_ms']:.3f} ms, prefill "
            f"{r['prefill_ms']:.3f} ms, decode {r['decode_ms_per_step']:.3f}"
            f" ms/step, {r['tokens_per_s']:.1f} tok/s, peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB")
    for what, r in moe["unit"]["served"].items():
        log(f"  MoE unit {moe['unit']['arch']} x 2 layers {what}: generate "
            f"{r['generate_ms']:.3f} ms, prefill {r['prefill_ms']:.3f} ms, "
            f"decode {r['decode_ms_per_step']:.3f} ms/step, peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB")
    for what, r in encdec["served"].items():
        log(f"  whisper {what}: generate {r['generate_ms']:.3f} ms, encoder "
            f"{r['encoder_ms']:.3f} ms, prefill {r['prefill_ms']:.3f} ms, "
            f"decode {r['decode_ms_per_step']:.3f} ms/step, "
            f"{r['tokens_per_s']:.1f} tok/s, peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB")
    for r in training["steps"]:
        log(f"  train {training['arch']} step {r['step']} ({r['accum']} x "
            f"{r['batch'] // r['accum']} x {training['seq']}): {r['ms']:.3f}"
            f" ms, {r['tokens_per_s']:.1f} tok/s, loss {r['loss']:.4f}, "
            f"peak {r['peak_bytes'] / 2**30:.2f} GiB")
    log(f"  whole script {time.perf_counter() - T_START:.1f} s")
    log(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
