// Mamba2 SSD intra-chunk term: Y = (L o C B^T) diag(dt) X per chunk and head.
//
// Replaces the TPU kernel `repro/kernels/ssd/ssd.py`
// (`ssd_intra_chunk_pallas`, body `_ssd_kernel`, ssd.py:20-37), which is
// the `y_intra` of `repro/layers/ssd.py:106-111`.  Inputs, contiguous:
// x (BC, Q, H, P) and b, c (BC, Q, N) of one type (float32 or bfloat16),
// dt (BC, Q, H) float32 and a (H,) float32, where BC = batch x chunks.
// For chunk z, head h and rows i, j of the chunk:
//   cs[i]   = sum_{k <= i} dt[k, h] a[h]
//   W[i, j] = (C_i . B_j) exp(cs[i] - cs[j]) dt[j, h]   for j <= i, else 0
//   Y[i, h] = sum_j W[i, j] X[j, h]
// all in float32; Y is written in float32 (BC, Q, H, P), because
// `ssd_chunked` keeps `y_intra` in float32 until it adds the inter-chunk
// term.  (The TPU kernel writes x's type; the port's tests compare with the
// JAX oracle cast to float32.)  Q is any chunk length up to 256, P is 16,
// 32 or 64, N any width (16, 64 and 128 in use).
//
// Bound: bytes.  The function reads x, dt, b and c once and writes Y once,
// and does Q(Q+1)/2 (N + P) multiply-adds per chunk and head pair (C B^T is
// per chunk, not per head), so at Zamba2's prefill (64 heads of P = 64,
// N = 64, Q = 256) the float32 output dominates and device memory bounds
// it.  The design computes C B^T once per (chunk, 64-row tile, group of 8
// heads) instead of once per head: the rows' G = C B^T tiles left of and on
// the diagonal stay in shared memory (tiled over N in slices of 32, so N =
// 128 at Q = 256 fits), and the block then walks its heads, building each
// 64 x 64 tile of W in shared memory from G, the head's cumulative decay
// and dt, and multiplying it into the 4 x P/16 accumulator block each
// thread keeps in registers.  Tiles above the diagonal are never built.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;        // rows (and columns) of a tile
constexpr int NS = 32;       // N slice staged per step of C B^T
constexpr int THREADS = 256;
constexpr int HEADS_PER_BLOCK = 8;
constexpr int MAX_Q = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory in floats for a chunk of q rows and head width p.
__host__ __device__ constexpr int smem_floats(int ntiles, int p) {
  return ntiles * T * (T + 1)                      // G tiles of the row tile
         + (2 * T * (NS + 1) > T * p + T * (T + 1)  // C/B slices, or X + W
                ? 2 * T * (NS + 1)
                : T * p + T * (T + 1))
         + 2 * MAX_Q;                              // cs and dt of one head
}

template <typename TX, int P>
__global__ void __launch_bounds__(THREADS)
    ssd_intra(const TX* __restrict__ x, const float* __restrict__ dt,
              const TX* __restrict__ bm, const TX* __restrict__ cm,
              const float* __restrict__ a, float* __restrict__ y, int q,
              int h, int n, int ntiles) {
  constexpr int GP = T + 1;
  constexpr int SP = NS + 1;
  constexpr int PPT = P / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* gs = smem;                        // ntiles x T x GP
  float* work = gs + ntiles * T * GP;      // C/B slices, then X and W
  float* cslice = work;                    // T x SP
  float* bslice = work + T * SP;           // T x SP
  float* xs = work;                        // T x P
  float* ws = work + T * P;                // T x GP
  const int wfloats = 2 * T * SP > T * P + T * GP ? 2 * T * SP
                                                  : T * P + T * GP;
  float* cs = work + wfloats;              // q
  float* dts = cs + MAX_Q;                 // q

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int rt = blockIdx.x;               // row tile
  const int h0 = blockIdx.y * HEADS_PER_BLOCK;
  const long long z = blockIdx.z;          // batch x chunk
  const int i0 = rt * T;

  const TX* cz = cm + z * q * n;
  const TX* bz = bm + z * q * n;
  // G[i, j] = C_i . B_j for the tiles jt <= rt.
  for (int jt = 0; jt <= rt; ++jt) {
    const int j0 = jt * T;
    float g[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
    for (int n0 = 0; n0 < n; n0 += NS) {
      __syncthreads();
      for (int idx = tid; idx < T * NS; idx += THREADS) {
        const int r = idx / NS, c = idx - r * NS;
        const int nn = n0 + c;
        const bool inn = nn < n;
        cslice[r * SP + c] =
            (inn && i0 + r < q) ? to_f(cz[(i0 + r) * n + nn]) : 0.f;
        bslice[r * SP + c] =
            (inn && j0 + r < q) ? to_f(bz[(j0 + r) * n + nn]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int nn = 0; nn < NS; ++nn) {
        float ca[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ca[r] = cslice[(ty * 4 + r) * SP + nn];
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = bslice[(tx + 16 * c) * SP + nn];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = fmaf(ca[r], bb[c], g[r][c]);
      }
    }
    float* gt = gs + jt * T * GP;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) gt[(ty * 4 + r) * GP + tx + 16 * c] = g[r][c];
  }

  const int h1 = h0 + HEADS_PER_BLOCK < h ? h0 + HEADS_PER_BLOCK : h;
  for (int hh = h0; hh < h1; ++hh) {
    __syncthreads();  // G is written; the last head's readers are done
    const float ah = a[hh];
    for (int t = tid; t < q; t += THREADS) {
      const float d = dt[(z * q + t) * h + hh];
      dts[t] = d;
      cs[t] = d * ah;
    }
    // Inclusive prefix sum of cs over the q <= 256 rows (Hillis-Steele).
    for (int off = 1; off < q; off <<= 1) {
      __syncthreads();
      const float add = (tid < q && tid >= off) ? cs[tid - off] : 0.f;
      __syncthreads();
      if (tid < q) cs[tid] += add;
    }

    float acc[4][PPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int d = 0; d < PPT; ++d) acc[r][d] = 0.f;
    const TX* xz = x + (z * q) * static_cast<long long>(h) * P +
                   static_cast<long long>(hh) * P;
    for (int jt = 0; jt <= rt; ++jt) {
      const int j0 = jt * T;
      __syncthreads();  // cs complete; the last tile's readers are done
      for (int idx = tid; idx < T * P; idx += THREADS) {
        const int r = idx / P, c = idx - r * P;
        const int j = j0 + r;
        xs[r * P + c] =
            j < q ? to_f(xz[static_cast<long long>(j) * h * P + c]) : 0.f;
      }
      const float* gt = gs + jt * T * GP;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx + 16 * c;
          float w = 0.f;
          if (i < q && j <= i)
            w = gt[(ty * 4 + r) * GP + tx + 16 * c] * expf(cs[i] - cs[j]) *
                dts[j];
          ws[(ty * 4 + r) * GP + tx + 16 * c] = w;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < T; ++kk) {
        float wr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wr[r] = ws[(ty * 4 + r) * GP + kk];
#pragma unroll
        for (int d = 0; d < PPT; ++d) {
          const float xv = xs[kk * P + tx + 16 * d];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][d] = fmaf(wr[r], xv, acc[r][d]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i < q) {
        float* yr = y + ((z * q + i) * h + hh) * static_cast<long long>(P);
#pragma unroll
        for (int d = 0; d < PPT; ++d) yr[tx + 16 * d] = acc[r][d];
      }
    }
  }
}

template <typename TX, int P>
int launch(const void* x, const float* dt, const void* b, const void* c,
           const float* a, float* y, long long bc, long long q, long long h,
           long long n, cudaStream_t stream) {
  const int ntiles = static_cast<int>((q + T - 1) / T);
  const int bytes = smem_floats(ntiles, P) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      ssd_intra<TX, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(ntiles,
                  static_cast<unsigned>((h + HEADS_PER_BLOCK - 1) /
                                        HEADS_PER_BLOCK),
                  static_cast<unsigned>(bc));
  ssd_intra<TX, P><<<grid, THREADS, bytes, stream>>>(
      static_cast<const TX*>(x), dt, static_cast<const TX*>(b),
      static_cast<const TX*>(c), a, y, static_cast<int>(q),
      static_cast<int>(h), static_cast<int>(n), ntiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int dispatch_p(const void* x, const float* dt, const void* b, const void* c,
               const float* a, float* y, long long bc, long long q,
               long long h, long long p, long long n, cudaStream_t s) {
  switch (p) {
    case 16: return launch<TX, 16>(x, dt, b, c, a, y, bc, q, h, n, s);
    case 32: return launch<TX, 32>(x, dt, b, c, a, y, bc, q, h, n, s);
    case 64: return launch<TX, 64>(x, dt, b, c, a, y, bc, q, h, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (bc, q, h, p) and b, c: (bc, q, n) of one type (dtype 0 = float32,
// 1 = bfloat16); dt: (bc, q, h) and a: (h,) float32; y: (bc, q, h, p)
// float32.  1 <= q <= 256, p in {16, 32, 64}, n >= 1, bc up to 65535.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_intra_chunk(const void* x, const float* dt, const void* b,
                               const void* c, const float* a, float* y,
                               long long bc, long long q, long long h,
                               long long p, long long n, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  if (q < 1 || q > MAX_Q || n < 1 || bc > 65535 || h > 65535 * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_p<float>(x, dt, b, c, a, y, bc, q, h, p, n, s);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(x, dt, b, c, a, y, bc, q, h, p, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
