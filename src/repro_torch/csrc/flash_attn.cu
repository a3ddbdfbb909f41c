// Flash attention forward: causal or full grouped-query softmax attention.
//
// Replaces the TPU kernel `repro/kernels/flash_attn/flash_attn.py`
// (`flash_attention_pallas`, body `_flash_kernel`, flash_attn.py:24-62).
// q is (B, Sq, H, D), k and v are (B, Sk, KV, D), all contiguous and of one
// type (float32 or bfloat16); query head h reads key/value head
// h / (H / KV).  For each query row i the kernel computes
// softmax(q_i k_j^T / sqrt(D)) v over the keys j (j <= i when causal,
// with i and j both counted from 0, as `flash_attention_ref`), keeping the
// softmax statistics and the accumulator in float32, and writes the row
// in q's type.  Any Sq and Sk: the ragged last tiles are masked inside the
// kernel.  D is one of 16, 32, 64, 96, 128.
//
// Bound: operations at long sequences.  The function reads q, k and v once
// and writes o once, 2 (B Sq H D) + 2 (B Sk KV D) elements, and does
// 4 D multiply-adds per (query, key) pair that is not masked, so at the
// Zamba2 prefill shape (4, 2048, 32 heads, 64) it is about 69 GFLOP over
// 134 MB: the tensor cores' rate bounds it.  Every path keeps the (Sq, Sk)
// scores out of device memory: a block owns a tile of query rows of one
// (batch, head) and streams tiles of K and V through shared memory, with
// the online-softmax state (m, l) and the output accumulator in registers.
// Key tiles wholly above the diagonal are skipped, as the TPU kernel skips
// them, and the tiles with most work are scheduled first.  A masked score
// gets weight exactly 0, so the ragged tail adds nothing even to a row
// whose visible keys all lie in later tiles.
//
// Three variants; the wrapper picks one by dtype and D (never on failure):
// * wgmma (bfloat16, D = 64 and 128): Hopper's warpgroup MMA fed by TMA
//   through a four-stage K/V ring; persistent blocks with a producer and
//   three (D = 64) or two (D = 128) consumer warpgroups (namespace wg
//   below).  P is rounded to bfloat16 for the second product, as `_sdpa`
//   rounds its weights.
// * mma_sync (bfloat16, D = 16, 32, 96): mma.sync m16n8k16, 4 warps of 16
//   query rows, Q in registers, one unpipelined 64-key K/V tile.
// * cuda_cores (float32, any D): full float32 FMAs (the tensor cores would
//   round to TF32 and miss the 3e-5 tolerance): 256 threads, each holding
//   a 4 x 4 block of scores and a 4 x D/16 block of the output, row
//   statistics reduced over 16 lanes with warp shuffles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per streamed tile
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

// -- float32: CUDA cores --------------------------------------------------

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int sq,
                  int sk, int h, int kvh, int nqt, int causal, float scale) {
  constexpr int DP = D + 1;   // padded rows: no bank conflicts on K reads
  constexpr int PP = BK + 1;
  constexpr int DPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x DP
  float* ks = qs + BQ * DP;    // BK x DP
  float* vs = ks + BK * DP;    // BK x D
  float* ps = vs + BK * D;     // BQ x PP

  const int tid = threadIdx.x;
  const int ty = tid >> 4;     // rows 4 ty .. 4 ty + 3 of the tile
  const int tx = tid & 15;     // keys / columns tx + 16 c
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x);
  const int hi = blockIdx.y;
  const long long bi = blockIdx.z;
  const int hk = hi / (h / kvh);
  const int q0 = qt * BQ;

  const long long qstride = static_cast<long long>(h) * D;
  const long long kstride = static_cast<long long>(kvh) * D;
  const float* qb = q + bi * sq * qstride + static_cast<long long>(hi) * D;
  const float* kb = k + bi * sk * kstride + static_cast<long long>(hk) * D;
  const float* vb = v + bi * sk * kstride + static_cast<long long>(hk) * D;
  float* ob = o + bi * sq * qstride + static_cast<long long>(hi) * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int i = q0 + r;
    qs[r * DP + c] = i < sq ? qb[i * qstride + c] : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[r][d] = 0.f;
  }

  int nkt = (sk + BK - 1) / BK;
  if (causal) {
    const int upper = (q0 + BQ - 1) / BK + 1;  // tiles with a key <= row
    nkt = nkt < upper ? nkt : upper;
  }
  for (int jt = 0; jt < nkt; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the last tile's readers are done with ks, vs, ps
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx - r * D;
      const int j = k0 + r;
      float kk = 0.f, vv = 0.f;
      if (j < sk) {
        kk = kb[j * kstride + c];
        vv = vb[j * kstride + c];
      }
      ks[r * DP + c] = kk;
      vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qs[(ty * 4 + r) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        ok[c] = j < sk && (!causal || j <= i);
        s[r][c] = ok[c] ? s[r][c] * scale : NEG;
        mx = fmaxf(mx, s[r][c]);
      }
      // The 16 lanes tx = 0..15 of a half warp share rows 4 ty .. 4 ty + 3.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - mnew) : 0.f;
        rs += p;
        ps[(ty * 4 + r) * PP + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * alpha + rs;
      m[r] = mnew;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[r][d] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = ps[(ty * 4 + r) * PP + kk];
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        const float vv = vs[kk * D + tx + 16 * d];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][d] = fmaf(p[r], vv, acc[r][d]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i < sq) {
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int d = 0; d < DPT; ++d)
        ob[i * qstride + tx + 16 * d] = acc[r][d] / denom;
    }
  }
}

// -- bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulate) ---------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows = BQ

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col), f32 C.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment of a 16 x 8 slice of a row-major [key][dim] tile: rows
// (keys) from lanes 0-15's addresses, transposed on the way in.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// Warp w owns query rows q0 + 16 w .. + 15; lane (g = lane / 4, t = lane %
// 4) holds rows g and g + 8 of them in the mma fragment layouts.  Q stays
// in registers as A fragments; each 64-key tile of K and V is staged in
// shared memory (rows padded by 8 elements: conflict-free fragment loads),
// S = Q K^T and the online softmax run on the accumulator fragments, and
// the probabilities, rounded to bf16, are the A fragments of O += P V.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int sq, int sk, int h,
                   int kvh, int nqt, int causal, float scale) {
  constexpr int S = D + 8;         // shared row stride, elements
  constexpr int KSTEPS = D / 16;   // k-steps of Q K^T
  constexpr int DN = D / 8;        // 8-wide column tiles of O
  constexpr int NT = BK / 8;       // 8-wide key tiles of S
  __shared__ __align__(16) __nv_bfloat16 ks[BK * S];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * S];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x);
  const int hi = blockIdx.y;
  const long long bi = blockIdx.z;
  const int hk = hi / (h / kvh);
  const int q0 = qt * BQ;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const long long qstride = static_cast<long long>(h) * D;
  const long long kstride = static_cast<long long>(kvh) * D;
  const __nv_bfloat16* qb = q + bi * sq * qstride + static_cast<long long>(hi) * D;
  const __nv_bfloat16* kb = k + bi * sk * kstride + static_cast<long long>(hk) * D;
  const __nv_bfloat16* vb = v + bi * sk * kstride + static_cast<long long>(hk) * D;
  __nv_bfloat16* ob = o + bi * sq * qstride + static_cast<long long>(hi) * D;

  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int col = kk * 16 + t * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rows[e & 1];
      qa[kk][e] = row < sq ? ld32(qb + row * qstride + col + (e >> 1) * 8)
                           : 0u;
    }
  }

  float oacc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dn][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  int nkt = (sk + BK - 1) / BK;
  if (causal) {
    const int upper = (q0 + BQ - 1) / BK + 1;
    nkt = nkt < upper ? nkt : upper;
  }
  for (int jt = 0; jt < nkt; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the last tile's readers are done with ks, vs
    for (int idx = tid; idx < BK * (D / 8); idx += MMA_THREADS) {
      const int r = idx / (D / 8), c = (idx - r * (D / 8)) * 8;
      const int j = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j < sk) {
        kv = *reinterpret_cast<const uint4*>(kb + j * kstride + c);
        vv = *reinterpret_cast<const uint4*>(vb + j * kstride + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * S + c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r * S + c]) = vv;
    }
    __syncthreads();

    float sacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kp = &ks[(nt * 8 + g) * S + kk * 16 + t * 2];
        mma_16816(sacc[nt], qa[kk], ld32(kp), ld32(kp + 8));
      }

    // Entries e = 0, 1 are row rows[0], e = 2, 3 row rows[1]; the 4
    // lanes of a quad (same g) hold the rest of those rows.
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const bool ok = col < sk && (!causal || col <= row);
        sacc[nt][e] = ok ? sacc[nt][e] * scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[nt][e]);
      }
    float alpha[2], mnew[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mnew[i] = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - mnew[i]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Exactly NEG only where masked: weight 0 there.
        const float p =
            sacc[nt][e] == NEG ? 0.f : expf(sacc[nt][e] - mnew[e >> 1]);
        sacc[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
      m[i] = mnew[i];
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[dn][e] *= alpha[e >> 1];

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
          pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
          pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, &vs[(kk * 16 + (lane & 15)) * S + dn * 8]);
        mma_16816(oacc[dn], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row < sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        *reinterpret_cast<uint32_t*>(ob + row * qstride + dn * 8 + t * 2) =
            pack_bf16(oacc[dn][2 * i] / denom, oacc[dn][2 * i + 1] / denom);
    }
  }
}

// -- bfloat16, D = 64 and 128: wgmma + TMA, warp-specialised --------------
//
// Persistent blocks, one per SM, take query tiles of one (batch, query
// head) from a counter: 64 rows per consumer warpgroup (three at D = 64,
// two at D = 128) and a producer that loads each tile's Q (double-
// buffered) and streams K and V tiles through a ring of STAGES shared-
// memory stages with TMA (cp.async.bulk.tensor, 4-D maps over the
// (B, S, heads, D) layout, 128-byte swizzle), each stage guarded by a
// "full" mbarrier (TMA bytes landed) and an "empty" one (every consumer
// warp is done with it).  A consumer warpgroup computes S = Q K^T with
// wgmma (Q and K both K-major in shared memory), runs the online softmax
// on the accumulator fragments, rounds P to bf16 straight into wgmma's
// register A operand and accumulates O += P V with V as the MN-major
// shared-memory B operand.  S of key tile j + 1 goes to the tensor cores
// with P V of tile j, so the softmax of tile j + 1 runs while P V does.
// Rows wider than 64 bf16 (D = 128) are stored as two 64-column boxes,
// each a 128-byte swizzle atom wide.
namespace wg {

constexpr int STAGES = 4;
constexpr int HEAD_GROUP = 32;             // heads whose tiles run together
constexpr int ROW_BYTES = 128;             // one 64-column box row

template <int D>
struct Cfg {
  // Consumer warpgroups of 64 rows each.  With three, the producer is a
  // whole warpgroup that hands most of its registers to the consumers
  // (setmaxnreg); with two, one producer warp leaves them enough, and
  // they take turns at the tensor cores so that one's softmax overlaps
  // the other's products.
  static constexpr int CONSUMERS = D == 64 ? 3 : 2;
  static constexpr bool REBALANCE = CONSUMERS >= 3;
  static constexpr bool TURNS = CONSUMERS == 2;
  static constexpr int BQ = 64 * CONSUMERS;         // query rows per tile
  static constexpr int THREADS = 128 * CONSUMERS + (REBALANCE ? 128 : 32);
  static constexpr int PRODUCER_REGS = 32;
  static constexpr int CONSUMER_REGS =
      (65536 - 128 * PRODUCER_REGS) / (128 * CONSUMERS) / 8 * 8;
  static constexpr int BK = D == 64 ? 128 : 64;   // keys per stage
  static constexpr int HALVES = D / 64;           // 64-column boxes
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // K or V, one stage
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES +
                              8 * (2 * STAGES + 4) + 2 * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map, coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  For a K-major
// operand (Q, K) the 8-row groups lie `sbo` = 1024 bytes apart and the
// leading offset is unused; for the MN-major V each 16-key step is two
// 8-row groups 1024 bytes apart, one 64-column atom wide, so both
// offsets are 1024 (the only one that is read then is the 8-row stride,
// whichever field the hardware takes it from).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching accumulator registers across the
// asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, float32 fragments) += A B for A (64 x 16) and B (128 x 16),
// both K-major bf16 in shared memory behind descriptors.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32 fragments) += A B for A (64 x 16) and B (64 x 16),
// both K-major bf16 in shared memory behind descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32 fragments) += A B for A (64 x 16) bf16 in registers
// (four packed pairs per thread) and B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int BK>
__device__ __forceinline__ void qk_step(float (&s)[BK / 2], uint64_t da,
                                        uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void qk_step<128>(float (&s)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  wgmma_ss_n128(s, da, db, accumulate);
}
template <>
__device__ __forceinline__ void qk_step<64>(float (&s)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  wgmma_ss_n64(s, da, db, accumulate);
}

// S = Q K^T for this warpgroup's 64 rows and one stage's BK keys: D / 16
// K-steps of 16 columns (32 bytes inside a 128-byte swizzled row, the next
// 64-column box after four).
template <int D, int BK, int BQ>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t qa,
                                         uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da =
        sw128_desc(qa + (kk / 4) * BQ * ROW_BYTES + col, 16, 1024);
    const uint64_t db =
        sw128_desc(ks + (kk / 4) * BK * ROW_BYTES + col, 16, 1024);
    qk_step<BK>(s, da, db, kk > 0);
  }
}

// O += P V: 16 keys per step, one 64-column box of V per instruction.
template <int BK, int HALVES>
__device__ __forceinline__ void issue_pv(float (&o)[HALVES][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
      wgmma_rs_n64(o[hf], pa[kk],
                   sw128_desc(vs + hf * BK * ROW_BYTES + kk * 16 * ROW_BYTES,
                              1024, 1024),
                   1);
}

// Whether some score of the key tile at k0 is masked for rows from rbase
// on: the ragged Sk tail, or a key above the diagonal.
__device__ __forceinline__ bool tile_masked(int k0, int bk, int sk,
                                            int causal, int rbase) {
  return k0 + bk > sk || (causal && k0 + bk - 1 > rbase);
}

// The online softmax of one tile's scores, in place: s becomes the
// weights exp(s - m_new) (exactly 0 where masked), m the new row maxima,
// l (this lane's share of the row sums) is rescaled and added to, and
// alpha = exp(m_old - m_new) is left for the output.  Entry i of s is key
// k0 + 8 (i / 4) + 2 t4 + (i & 1) of row (i & 2 ? row1 : row0).
template <int BK>
__device__ __forceinline__ void online_softmax(
    float (&s)[BK / 2], bool masked, int k0, int row0, int row1, int t4,
    int sk, int causal, float scale_log2, float (&m)[2], float (&l)[2],
    float (&alpha)[2]) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
      const int row = (i & 2) ? row1 : row0;
      if (col >= sk || (causal && col > row)) s[i] = NEG;
    }
  }
  // Row maxima and sums over 4 partials per row: short dependency chains.
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) mx[0][c] = mx[1][c] = NEG;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float& x = mx[(i >> 1) & 1][(i & 1) | ((i >> 1) & 2)];
    x = fmaxf(x, s[i]);
  }
  float msc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float mnew = fmaxf(m[r], v);
    alpha[r] = ex2((m[r] - mnew) * scale_log2);
    m[r] = mnew;
    msc[r] = mnew * scale_log2;
#pragma unroll
    for (int c = 0; c < 4; ++c) sum[r][c] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    float p = ex2(fmaf(s[i], scale_log2, -msc[r]));
    if (masked && s[i] == NEG) p = 0.f;
    s[i] = p;
    sum[r][(i & 1) | ((i >> 1) & 2)] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] +
           ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// O *= alpha row by row: the accumulator moves to the new row maxima.
template <int HALVES>
__device__ __forceinline__ void rescale(float (&o)[HALVES][32],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[hf][e] *= alpha[(e >> 1) & 1];
}

// P rounded to bf16 as wgmma's register A operand: the accumulator
// fragments of keys 16 kk .. 16 kk + 15 are the A fragment of step kk.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// Query tile i of the launch, in schedule order: groups of HEAD_GROUP
// (batch, head) pairs one after the other, so the tiles in flight share a
// few heads' K and V in L2; within a group the heaviest tiles (most key
// tiles) first.
struct Tile {
  int q0, hi, bi;
};
__device__ __forceinline__ Tile tile_of(long long i, int nqt, int h,
                                        long long heads, int bq) {
  const long long span = static_cast<long long>(HEAD_GROUP) * nqt;
  const long long first = i / span * HEAD_GROUP;   // the group's first head
  const long long j = i - first * nqt;
  const long long n =
      heads - first < HEAD_GROUP ? heads - first : HEAD_GROUP;
  const long long level = j / n;                   // 0: the heaviest tiles
  const long long head = first + (j - level * n);
  return {(nqt - 1 - static_cast<int>(level)) * bq,
          static_cast<int>(head % h), static_cast<int>(head / h)};
}

// Key tiles of the query tile at q0 (none above the diagonal).
__device__ __forceinline__ int key_tiles(int q0, int bq, int sq, int sk,
                                         int bk, int causal) {
  const int n = (sk + bk - 1) / bk;
  return causal ? min(n, (min(q0 + bq, sq) - 1) / bk + 1) : n;
}

// Key tiles that the 64 rows from rb compute: those with a key at or
// below the rows' last real row (all nkt when not causal).
__device__ __forceinline__ int tiles_for_rows(int rb, int nkt, int sq,
                                              int bk, int causal) {
  if (rb >= sq) return 0;
  return causal ? min(nkt, min(rb + 63, sq - 1) / bk + 1) : nkt;
}

// Turns of the consumer warpgroups at the tensor cores, round robin on
// named barriers 1 .. nc: warpgroup w waits for its turn on barrier 1 + w
// and hands the turn to the next on barrier 1 + (w + 1) % nc.
template <bool kOn>
__device__ __forceinline__ void turn_begin(int w) {
  if constexpr (kOn)
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
}
template <bool kOn>
__device__ __forceinline__ void turn_end(int w, int nc) {
  if constexpr (kOn)
    asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (w + 1) % nc)
                 : "memory");
}

// Persistent: one block per SM takes query tiles from the counter
// next_tile (zero at launch) until they run out.  The K/V ring and its
// phases run on across tiles, and Q is double-buffered, so the producer
// loads the next tile while the consumers finish this one.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o,
                    unsigned long long* __restrict__ next_tile, int sq,
                    int sk, int h, int kvh, int nqt, long long heads,
                    int causal, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, HALVES = C::HALVES;
  constexpr int CONSUMERS = C::CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  // Swizzle atoms need 1024-byte alignment.
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 2 buffers
  const uint32_t k_s = q_s + 2 * C::Q_BYTES;  // stage s at + s * KV_BYTES
  const uint32_t v_s = k_s + STAGES * C::KV_BYTES;
  // mbarriers: K/V full[s], K/V empty[s], Q full[2], Q empty[2].
  const uint32_t bars = v_s + STAGES * C::KV_BYTES;
  const uint32_t qbars = bars + 16 * STAGES;
  // The tile in each Q buffer, as the producer took it from next_tile.
  volatile long long* slot = reinterpret_cast<volatile long long*>(
      smem_raw + (qbars + 32 - smem_u32(smem_raw)));
  const long long ntiles = heads * nqt;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = h / kvh;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 4 * CONSUMERS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(qbars + 8 * b, 1);
      mbar_init(qbars + 8 * (2 + b), 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // the producer; one thread works
    if constexpr (C::REBALANCE)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          C::PRODUCER_REGS));
    if (warp == 4 * CONSUMERS && lane == 0) {
      int it = 0;  // K/V ring position
      for (int tc = 0;; ++tc) {
        const int qb = tc & 1;
        mbar_wait(qbars + 8 * (2 + qb), ((tc >> 1) & 1) ^ 1);
        // Tiles go to blocks as they free up: the heavy tiles of a head
        // group first, so the blocks end together.
        const long long i =
            static_cast<long long>(atomicAdd(next_tile, 1ull));
        slot[qb] = i;
        if (i >= ntiles) {  // the consumers read the end from the slot
          mbar_arrive(qbars + 8 * qb);
          break;
        }
        const Tile t = tile_of(i, nqt, h, heads, BQ);
        mbar_expect_tx(qbars + 8 * qb, C::Q_BYTES);
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load(q_s + qb * C::Q_BYTES + hf * BQ * ROW_BYTES, &tq,
                   qbars + 8 * qb, hf * 64, t.hi, t.q0, t.bi);
        const int nkt = key_tiles(t.q0, BQ, sq, sk, BK, causal);
        for (int jt = 0; jt < nkt; ++jt, ++it) {
          const int s = it % STAGES;
          const uint32_t full = bars + 8 * s;
          mbar_wait(bars + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full, 2 * C::KV_BYTES);
          for (int hf = 0; hf < HALVES; ++hf) {
            const uint32_t off = s * C::KV_BYTES + hf * BK * ROW_BYTES;
            tma_load(k_s + off, &tk, full, hf * 64, t.hi / group, jt * BK,
                     t.bi);
            tma_load(v_s + off, &tv, full, hf * 64, t.hi / group, jt * BK,
                     t.bi);
          }
        }
      }
    }
    return;  // consumers never use __syncthreads after this point
  }

  // Consumer warpgroup wgi owns rows rbase .. rbase + 63 of each tile; in
  // its warp w4, lane (g, t4) holds rows row0 = rbase + 16 w4 + g and
  // row0 + 8.
  if constexpr (C::REBALANCE)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        C::CONSUMER_REGS));
  const int wgi = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const long long qstride = static_cast<long long>(h) * D;
  int it = 0;
  if (wgi == CONSUMERS - 1)  // warpgroup 0 takes the first turn
    turn_end<C::TURNS>(wgi, CONSUMERS);
  for (int tc = 0;; ++tc) {
    const int qb = tc & 1;
    mbar_wait(qbars + 8 * qb, (tc >> 1) & 1);
    const long long i = slot[qb];
    if (i >= ntiles) break;
    const Tile t = tile_of(i, nqt, h, heads, BQ);
    const int nkt = key_tiles(t.q0, BQ, sq, sk, BK, causal);
    const int rbase = t.q0 + 64 * wgi;
    const int row0 = rbase + 16 * w4 + g, row1 = row0 + 8;
    const uint32_t qa = q_s + qb * C::Q_BYTES + 64 * wgi * ROW_BYTES;

    float oacc[HALVES][32];
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[hf][e] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this lane's share
    float alpha[2];
    float sacc[BK / 2];
    uint32_t pa[BK / 16][4];

    // With TURNS the warpgroups take turns at the tensor cores: one
    // issues its wgmmas in its turn and hands the turn on, so its softmax
    // runs while the others' products do.  Each takes nkt + 1 turns per
    // tile (the warpgroup with the tile's last row computes all nkt key
    // tiles; one with fewer takes empty turns).
    const int n_mine = tiles_for_rows(rbase, nkt, sq, BK, causal);
    const int turns = nkt + 1;
    int turn = 0;
    if (n_mine > 0) {
      mbar_wait(bars + 8 * (it % STAGES), (it / STAGES) & 1);
      turn_begin<C::TURNS>(wgi);
      wgmma_fence();
      issue_qk<D, BK, BQ>(sacc, qa, k_s + (it % STAGES) * C::KV_BYTES);
      wgmma_commit();
      turn_end<C::TURNS>(wgi, CONSUMERS);
      ++turn;
      wgmma_wait<0>();
      reg_fence(sacc);
      online_softmax<BK>(sacc, tile_masked(0, BK, sk, causal, rbase), 0,
                         row0, row1, t4, sk, causal, scale_log2, m, l,
                         alpha);
      pack_p<BK>(pa, sacc);
    }
    // Key tile jt: in one turn S of tile jt + 1 and P V of tile jt go to
    // the tensor cores; the softmax of tile jt + 1 then runs while P V
    // does.  The last tile is peeled off, so the loop issues its wgmmas
    // unconditionally.
    for (int jt = 0; jt + 1 < n_mine; ++jt, ++it, ++turn) {
      const int s = it % STAGES, sn = (it + 1) % STAGES;
      mbar_wait(bars + 8 * sn, ((it + 1) / STAGES) & 1);
      turn_begin<C::TURNS>(wgi);
      wgmma_fence();
      issue_qk<D, BK, BQ>(sacc, qa, k_s + sn * C::KV_BYTES);
      wgmma_commit();
      issue_pv<BK, HALVES>(oacc, pa, v_s + s * C::KV_BYTES);
      wgmma_commit();
      turn_end<C::TURNS>(wgi, CONSUMERS);
      wgmma_wait<1>();  // S of tile jt + 1 is in; P V is still running
      reg_fence(sacc);
      const int k1 = (jt + 1) * BK;
      online_softmax<BK>(sacc, tile_masked(k1, BK, sk, causal, rbase), k1,
                         row0, row1, t4, sk, causal, scale_log2, m, l,
                         alpha);
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) reg_fence(oacc[hf]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));  // release
      rescale(oacc, alpha);
      pack_p<BK>(pa, sacc);
    }
    if (n_mine > 0) {
      const int s = it % STAGES;
      turn_begin<C::TURNS>(wgi);
      wgmma_fence();
      issue_pv<BK, HALVES>(oacc, pa, v_s + s * C::KV_BYTES);
      wgmma_commit();
      turn_end<C::TURNS>(wgi, CONSUMERS);
      ++turn;
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) reg_fence(oacc[hf]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));
      ++it;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(qbars + 8 * (2 + qb));  // done with Q
    // Empty turns keep the two warpgroups in step.  In turn j it releases
    // key tile j - 1 if it did not compute it, as the other does, waiting
    // for the tile first so that the arrival belongs to the stage's
    // current phase.
    for (; turn < turns; ++turn) {
      turn_begin<C::TURNS>(wgi);
      turn_end<C::TURNS>(wgi, CONSUMERS);
      if (turn > 0) {
        const int s = it % STAGES;
        mbar_wait(bars + 8 * s, (it / STAGES) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));
        ++it;
      }
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* ob = o + static_cast<long long>(t.bi) * sq * qstride +
                        static_cast<long long>(t.hi) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      if (row < sq) {
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
          for (int dn = 0; dn < 8; ++dn)
            *reinterpret_cast<uint32_t*>(ob + row * qstride + hf * 64 +
                                         dn * 8 + 2 * t4) =
                pack_bf16(oacc[hf][4 * dn + 2 * r] * inv[r],
                          oacc[hf][4 * dn + 2 * r + 1] * inv[r]);
      }
    }
  }
  if (wgi == 0) turn_begin<C::TURNS>(0);  // the last hand-over of the launch
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry
// points, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map {D, heads, S, B} of a contiguous (B, S, heads, D) bf16
// tensor, one box = 64 columns x `rows` rows of one head.
int make_map(CUtensorMap* map, const void* ptr, long long d,
             long long heads, long long s, long long b, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d * 2),
                                 static_cast<cuuint64_t>(heads * d * 2),
                                 static_cast<cuuint64_t>(s * heads * d * 2)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

constexpr int MAX_DEVICES = 64;

// Streaming multiprocessors of device `dev` (one block each), asked once.
int num_sms(int dev) {
  static int known[MAX_DEVICES] = {};
  int& n = known[dev % MAX_DEVICES];
  if (n < 1 && (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                       dev) != cudaSuccess || n < 1))
    n = 132;
  return n;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           void* next_tile, long long b, long long sq, long long sk,
           long long h, long long kvh, int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  const long long nqt = (sq + C::BQ - 1) / C::BQ;
  if (nqt > 0x7FFFFFFFLL || next_tile == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int e = make_map(&mq, q, D, h, sq, b, C::BQ);
  if (e == 0) e = make_map(&mk, k, D, kvh, sk, b, C::BK);
  if (e == 0) e = make_map(&mv, v, D, kvh, sk, b, C::BK);
  if (e != 0) return e;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  static bool smem_set[MAX_DEVICES] = {};  // the attribute, per device
  if (err == cudaSuccess && !smem_set[dev % MAX_DEVICES]) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    smem_set[dev % MAX_DEVICES] = err == cudaSuccess;
  }
  if (err == cudaSuccess)
    err = cudaMemsetAsync(next_tile, 0, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ntiles = nqt * h * b;
  const unsigned grid = static_cast<unsigned>(
      ntiles < num_sms(dev) ? ntiles : num_sms(dev));
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_fwd_wgmma<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o),
      static_cast<unsigned long long*>(next_tile), static_cast<int>(sq),
      static_cast<int>(sk), static_cast<int>(h), static_cast<int>(kvh),
      static_cast<int>(nqt), h * b, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                long long b, long long sq, long long sk, long long h,
                long long kvh, int causal, cudaStream_t stream) {
  const int nqt = static_cast<int>((sq + BQ - 1) / BQ);
  const dim3 grid(nqt, static_cast<unsigned>(h), static_cast<unsigned>(b));
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_bf16<D><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<int>(sq), static_cast<int>(sk), static_cast<int>(h),
      static_cast<int>(kvh), nqt, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               long long b, long long sq, long long sk, long long h,
               long long kvh, int causal, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nqt = static_cast<int>((sq + BQ - 1) / BQ);
  const dim3 grid(nqt, static_cast<unsigned>(h), static_cast<unsigned>(b));
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_f32<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<int>(sq),
      static_cast<int>(sk), static_cast<int>(h), static_cast<int>(kvh), nqt,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

constexpr int VARIANT_CUDA_CORES = 0, VARIANT_MMA_SYNC = 1, VARIANT_WGMMA = 2;

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           void* scratch, long long b, long long sq, long long sk,
           long long h, long long kvh, int causal, int dtype, int variant,
           cudaStream_t s) {
  if (dtype == 0 && variant == VARIANT_CUDA_CORES)
    return launch_f32<D>(q, k, v, o, b, sq, sk, h, kvh, causal, s);
  if (dtype == 1 && variant == VARIANT_MMA_SYNC)
    return launch_bf16<D>(q, k, v, o, b, sq, sk, h, kvh, causal, s);
  if constexpr (D == 64 || D == 128) {
    if (dtype == 1 && variant == VARIANT_WGMMA)
      return wg::launch<D>(q, k, v, o, scratch, b, sq, sk, h, kvh, causal,
                           s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o: (b, sq, h, d); k, v: (b, sk, kvh, d); contiguous, one type:
// dtype 0 = float32, 1 = bfloat16.  variant 0 = CUDA cores (float32),
// 1 = mma.sync (bfloat16), 2 = wgmma + TMA (bfloat16, d 64 or 128, every
// pointer 16-byte aligned; scratch: 8 bytes of device memory for its tile
// counter, unused by the others).  h % kvh == 0, d in {16, 32, 64, 96, 128},
// sq, sk >= 1, b and h up to 65535.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, long long b, long long sq,
                              long long sk, long long h, long long kvh,
                              long long d, int causal, int dtype,
                              int variant, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  if (sk < 1 || kvh < 1 || h % kvh != 0 || b > 65535 || h > 65535 ||
      sq > 0x7FFFFFFFLL || sk > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, o, scratch, b, sq, sk, h, kvh, causal,
                        dtype, variant, s);
    case 32:
      return launch<32>(q, k, v, o, scratch, b, sq, sk, h, kvh, causal,
                        dtype, variant, s);
    case 64:
      return launch<64>(q, k, v, o, scratch, b, sq, sk, h, kvh, causal,
                        dtype, variant, s);
    case 96:
      return launch<96>(q, k, v, o, scratch, b, sq, sk, h, kvh, causal,
                        dtype, variant, s);
    case 128:
      return launch<128>(q, k, v, o, scratch, b, sq, sk, h, kvh, causal,
                         dtype, variant, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
