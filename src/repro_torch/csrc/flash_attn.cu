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
// 134 MB: the tensor cores' rate bounds it.  Both paths keep the (Sq, Sk)
// scores out of device memory: a block owns a 64-row query tile of one
// (batch, head) and streams 64-key tiles of K and V through shared memory,
// with the online-softmax state (m, l) and the output accumulator in
// registers.  Key tiles wholly above the diagonal are skipped, as the TPU
// kernel skips them, and the tiles with most work are scheduled first.  A
// masked score gets weight exactly 0, so the ragged tail adds nothing even
// to a row whose visible keys all lie in later tiles.
//
// * bfloat16 runs on the tensor cores with mma.sync (m16n8k16, float32
//   accumulate): 4 warps of 16 query rows, Q kept in registers as A
//   fragments, S = Q K^T and P V from shared-memory tiles; P is rounded to
//   bfloat16 for the second product, as `_sdpa` rounds its weights.  No
//   wgmma, TMA or pipelining yet.
// * float32 runs on the CUDA cores in full float32 (the tensor cores would
//   round to TF32): 256 threads, each holding a 4 x 4 block of scores and
//   a 4 x D/16 block of the output, row statistics reduced over 16 lanes
//   with warp shuffles.
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           long long b, long long sq, long long sk, long long h,
           long long kvh, int causal, int dtype, cudaStream_t s) {
  return dtype == 0 ? launch_f32<D>(q, k, v, o, b, sq, sk, h, kvh, causal, s)
                    : launch_bf16<D>(q, k, v, o, b, sq, sk, h, kvh, causal,
                                     s);
}

}  // namespace

// q, o: (b, sq, h, d); k, v: (b, sk, kvh, d); contiguous, one type:
// dtype 0 = float32, 1 = bfloat16.  h % kvh == 0, d in {16, 32, 64, 96,
// 128}, sq, sk >= 1, b and h up to 65535.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, long long b, long long sq,
                              long long sk, long long h, long long kvh,
                              long long d, int causal, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  if (sk < 1 || kvh < 1 || h % kvh != 0 || b > 65535 || h > 65535 ||
      sq > 0x7FFFFFFFLL || sk > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return launch<16>(q, k, v, o, b, sq, sk, h, kvh, causal, dtype, s);
    case 32: return launch<32>(q, k, v, o, b, sq, sk, h, kvh, causal, dtype, s);
    case 64: return launch<64>(q, k, v, o, b, sq, sk, h, kvh, causal, dtype, s);
    case 96: return launch<96>(q, k, v, o, b, sq, sk, h, kvh, causal, dtype, s);
    case 128:
      return launch<128>(q, k, v, o, b, sq, sk, h, kvh, causal, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
