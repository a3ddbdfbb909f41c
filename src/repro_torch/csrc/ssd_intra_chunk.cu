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
// Y is written in float32 (BC, Q, H, P), because `ssd_chunked` keeps
// `y_intra` in float32 until it adds the inter-chunk term.  (The TPU kernel
// writes x's type; the port's tests compare with the JAX oracle cast to
// float32.)  Q is any chunk length up to 256, P is 16, 32 or 64, N is 16,
// 64 or 128.
//
// Bound: bytes.  The function reads x, dt, b and c once and writes Y once,
// and does Q(Q+1)/2 (N + P) multiply-adds per chunk and head pair (C B^T is
// per chunk, not per head), so at Zamba2's prefill (64 heads of P = 64,
// N = 64, Q = 256) the float32 output, two thirds of the bytes, bounds it.
//
// Two variants; the wrapper picks one by dtype (never on failure):
// * wgmma (bfloat16): flash attention's forward pass without the softmax
//   (namespace tc below).  C plays the queries, B the keys, X_h the values
//   and the decay mask the softmax.  Persistent blocks, about one work item
//   of (chunk, group of heads) per SM; a producer thread loads the chunk's
//   C and B once by TMA (128-byte swizzle, zero fill past Q and past N)
//   and each head's X_h behind a double buffer of mbarriers, and a
//   producer warp writes each head's cumulative decay (a warp-shuffle
//   scan) beside it.  Two consumer warpgroups own the chunk's 64-row
//   tiles in pairs of equal work ({3, 0} and {2, 1} at Q = 256), so
//   neither waits on the other.  Per row tile i and key tile j <= i:
//   S = C_i B_j^T by wgmma into float32 registers (recomputed per head),
//   W from S in registers with the decay, exact 0 above the diagonal,
//   then acc += W X_j by wgmma with W as the register A operand and X_j
//   MN-major in shared memory.  S of tile j + 1 is issued with
//   W X_j, so W of j + 1 is built while that product runs.  The decay is
//   never a product of exp(cs[i]) and exp(-cs[j]), which overflows over a
//   chunk: on the diagonal tile it is the exponent of the difference, and
//   below it exp(cs[i] - cs[r]) exp(cs[r] - cs[j]) through the key tile's
//   last row r, both factors at most 1.  W is split into a bfloat16 high
//   part and the bfloat16 rounding of the rest (two products): rounded
//   once, W misses the 3e-2 limit at Zamba2's shape.  Y leaves from the
//   accumulator fragments: 4 lanes write 32 contiguous bytes of a row, a
//   warp 8 rows per store.  What bounds it on the card, as measured with
//   tools/check_hopper_kernels.py --probe (PERF.md gives the times): the
//   chain of tensor-core products and exponentials within each SM (half
//   the SMs take twice as long), not device memory.
// * cuda_cores (float32, or bfloat16 when asked for): full float32 FMAs
//   (TF32 would miss the float32 limit of 2e-4).  C B^T is computed once
//   per (chunk, 64-row tile, group of 8 heads) into shared memory (tiled
//   over N in slices of 32), and the block walks its heads, building each
//   64 x 64 tile of W in shared memory and multiplying it into the 4 x P/16
//   accumulator block each thread keeps in registers.
#include <cuda.h>
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

// -- bfloat16: wgmma + TMA, warp-specialised ------------------------------
//
// Persistent blocks, at most one per SM, walk work items of (chunk z, group
// of hg heads).  The last warpgroup is the producer: one thread loads the
// chunk's C and B (nt row tiles of 64, NH boxes of 64 columns each) once
// per item, and each head's X_h (nt tiles) into one of two stages, by TMA
// with 128-byte swizzle; rows past Q and columns past N or P arrive as
// zeros.  Its next warp writes the head's cumulative decay and dt rows
// into the stage (off the consumers' path: taken there, the scan and its
// loads cost each head about a fifth of its time).  Each stage has a
// "full" mbarrier (TMA bytes landed and the rows written) and an "empty"
// one (every consumer warp is done with it).  The producer hands most of
// its registers to the consumers (setmaxnreg).  The other warpgroups are
// consumers; in warp w4 of one, lane (g, t4) holds rows 16 w4 + g and
// 16 w4 + g + 8 of a 64-row tile in wgmma's accumulator layout: entry e of
// a 64 x 64 float32 accumulator is column 8 (e / 4) + 2 t4 + (e & 1) of
// the row picked by e & 2.
namespace tc {

#ifndef SSD_SPLIT_W
#define SSD_SPLIT_W 1
#endif
// Consumer warpgroups: 2 own the row tiles {3, 0} and {2, 1} at Q = 256
// (5 and 5 key tiles), 3 own {3}, {2}, {1, 0} (4, 3 and 3).
#ifndef SSD_CONSUMERS
#define SSD_CONSUMERS 2
#endif
// Off the diagonal, exp(cs[i] - cs[j]) as exp(cs[i] - cs[r]) exp(cs[r] -
// cs[j]) with r the key tile's last row: both factors are at most 1, and
// a thread takes 18 exponentials a tile instead of 32 (0: one each).
#ifndef SSD_FACTOR_EXP
#define SSD_FACTOR_EXP 1
#endif
// Probing builds for tools/check_hopper_kernels.py: 2 replaces the decay's
// exponentials by 1 (a wrong Y, for timing only); 7 has block 0 write
// clock64() stamps of its consumer warpgroups into the start of Y instead
// of its rows (see STAMP below); SSD_GRID_CAP > 0 runs at most that many
// blocks, to tell per-SM limits from chip-wide ones.
#ifndef SSD_PROBE
#define SSD_PROBE 0
#endif
#ifndef SSD_GRID_CAP
#define SSD_GRID_CAP 0
#endif

constexpr int CONSUMERS = SSD_CONSUMERS;       // warpgroups of 128 threads
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS =
    (65536 - 128 * PRODUCER_REGS) / (128 * CONSUMERS) / 8 * 8;
constexpr int STAGES = 2;                       // X stages (heads)
constexpr int TILE_BYTES = 64 * 128;            // 64 rows x 64 bf16 columns
constexpr int CS_FLOATS = 2 * MAX_Q;            // a stage's cs2 and dt rows
constexpr float LOG2E = 1.4426950408889634f;
// SSD_PROBE 7: stamps per (warpgroup, head of block 0's first item):
// 0 head start, 2 X and its decay rows landed, then per row tile t (in
// the order taken) 3 + 12 t + k: k = 0 start, 1 S of key tile 0 in, 2 its
// W made, 3 packed; in key tile step 0: 4 S of tile 1 in, 5 its W made,
// 6 W X_0 done, 7 W packed; 8, 9 after steps 1, 2; 10 last W X done,
// 11 Y stored.  Warpgroup w writes them over row w of block 0's heads.
constexpr int STAMPS = 32;

// Dynamic shared memory for nt row tiles and nh 64-column boxes of N:
// C and B (nh nt tiles each), the X stages (nt tiles each), each stage's
// decay rows, the mbarriers, and 1024 bytes to align the swizzle atoms.
__host__ __device__ constexpr int smem_bytes(int nt, int nh) {
  return 1024 + (2 * nh + STAGES) * nt * TILE_BYTES +
         STAGES * CS_FLOATS * 4 + (2 + 2 * STAGES) * 8;
}

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

// One box of a 3-D (C, B) or 4-D (X) tensor map, coordinates innermost
// first.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (as flash_attn.cu's):
// K-major C and B tiles have their 8-row groups 1024 bytes apart; for the
// MN-major X tile each 16-row step is two such groups, one atom wide.
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
__device__ __forceinline__ void reg_fence(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64 float32) += A B, A (64 x 16) and B (64 x 16) K-major bf16 in
// shared memory.
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

// d (64 x 64 float32) += A B, A (64 x 16) bf16 in registers (four packed
// pairs per thread), B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = C_i B_j^T over the chunk's N columns: KSTEPS k-steps of 16 (32
// bytes inside a 128-byte swizzled row, the next 64-column box after
// four).
template <int KSTEPS>
__device__ __forceinline__ void issue_s(float (&s)[32], uint32_t c_s,
                                        uint32_t b_s, int nt, int i, int j) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t box = (kk / 4) * nt * TILE_BYTES, col = (kk % 4) * 32;
    wgmma_ss_n64(s, sw128_desc(c_s + box + i * TILE_BYTES + col, 16, 1024),
                 sw128_desc(b_s + box + j * TILE_BYTES + col, 16, 1024),
                 kk > 0);
  }
}

// acc += W X_j: 16 rows of X_j per step, W's high part (and low part).
__device__ __forceinline__ void issue_wx(float (&acc)[32],
                                         const uint32_t (&wh)[4][4],
                                         const uint32_t (&wl)[4][4],
                                         uint32_t xt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sw128_desc(xt + kk * 16 * 128, 1024, 1024);
    wgmma_rs_n64(acc, wh[kk], db);
    if (SSD_SPLIT_W) wgmma_rs_n64(acc, wl[kk], db);
  }
}

// S becomes W in place: W = S exp(cs[i] - cs[j]) dt[j] (cs2 = cs log2 e).
// On the diagonal tile the exponent is taken whole and W is exactly 0
// above the diagonal; below it (SSD_FACTOR_EXP) the decay is the product
// of a row factor and a column factor through the key tile's last row.
__device__ __forceinline__ void make_w(float (&s)[32], const float* cs2j,
                                       const float* dtj, float ci0, float ci1,
                                       bool diag, int lrow, int t4) {
  if (SSD_FACTOR_EXP && !diag) {
    const float cref = cs2j[63];
    const float r0 = SSD_PROBE == 2 ? 1.f : ex2(ci0 - cref);
    const float r1 = SSD_PROBE == 2 ? 1.f : ex2(ci1 - cref);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 cj =
          *reinterpret_cast<const float2*>(cs2j + 8 * c + 2 * t4);
      const float2 dj = *reinterpret_cast<const float2*>(dtj + 8 * c + 2 * t4);
      const float fx = (SSD_PROBE == 2 ? 1.f : ex2(cref - cj.x)) * dj.x;
      const float fy = (SSD_PROBE == 2 ? 1.f : ex2(cref - cj.y)) * dj.y;
      s[4 * c] = s[4 * c] * r0 * fx;
      s[4 * c + 1] = s[4 * c + 1] * r0 * fy;
      s[4 * c + 2] = s[4 * c + 2] * r1 * fx;
      s[4 * c + 3] = s[4 * c + 3] * r1 * fy;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 cj = *reinterpret_cast<const float2*>(cs2j + 8 * c + 2 * t4);
    const float2 dj = *reinterpret_cast<const float2*>(dtj + 8 * c + 2 * t4);
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) {
      const float ci = (e4 & 2) ? ci1 : ci0;
      const float decay =
          SSD_PROBE == 2 ? 1.f : ex2(ci - ((e4 & 1) ? cj.y : cj.x));
      const float w = s[4 * c + e4] * decay * ((e4 & 1) ? dj.y : dj.x);
      const int lc = 8 * c + 2 * t4 + (e4 & 1);
      s[4 * c + e4] = (diag && lc > lrow + ((e4 & 2) ? 8 : 0)) ? 0.f : w;
    }
  }
}

// W rounded to bf16 as wgmma's register A operand (the accumulator
// fragments of columns 16 kk .. 16 kk + 15 are the A fragment of step kk),
// and the rounding error, rounded again, as a second operand.
__device__ __forceinline__ void pack_w(uint32_t (&wh)[4][4],
                                       uint32_t (&wl)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = s[8 * kk + 2 * e], hi = s[8 * kk + 2 * e + 1];
      const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      wh[kk][e] = bits(v);
      if (SSD_SPLIT_W) {
        const float2 back = __bfloat1622float2(v);
        wl[kk][e] = bits(__floats2bfloat162_rn(lo - back.x, hi - back.y));
      }
    }
}

// Which of the nt row tiles consumer warpgroup w owns, as a bit mask: row
// tile r has r + 1 key tiles, and the tiles go, heaviest first, to the
// warpgroup with the least work so far.
__device__ __forceinline__ unsigned my_tiles(int nt, int w) {
  int load[CONSUMERS] = {};
  unsigned mine = 0;
  for (int r = nt - 1; r >= 0; --r) {
    int to = 0;
#pragma unroll
    for (int k = 1; k < CONSUMERS; ++k)
      if (load[k] < load[to]) to = k;
    load[to] += r + 1;
    if (to == w) mine |= 1u << r;
  }
  return mine;
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_intra_wgmma(const __grid_constant__ CUtensorMap tmc,
                    const __grid_constant__ CUtensorMap tmb,
                    const __grid_constant__ CUtensorMap tmx,
                    const float* __restrict__ dt, const float* __restrict__ a,
                    float* __restrict__ y, int q, int h, int p, int hg,
                    int groups, int items) {
  constexpr int NH = (N + 63) / 64;      // 64-column boxes of C and B
  constexpr int KSTEPS = (N + 15) / 16;  // k-steps of C B^T
  extern __shared__ unsigned char smem_raw[];
  const int nt = (q + 63) / 64;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t c_s = (raw + 1023u) & ~1023u;           // [NH][nt] tiles
  const uint32_t b_s = c_s + NH * nt * TILE_BYTES;        // [NH][nt]
  const uint32_t x_s = b_s + NH * nt * TILE_BYTES;        // [STAGES][nt]
  const uint32_t w_s = x_s + STAGES * nt * TILE_BYTES;    // decay rows
  const uint32_t bars = w_s + STAGES * CS_FLOATS * 4;
  const uint32_t cb_full = bars, cb_empty = bars + 8;
  const uint32_t x_full = bars + 16;                // [STAGES]
  const uint32_t x_empty = x_full + 8 * STAGES;     // [STAGES]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(cb_full, 1);
    mbar_init(cb_empty, 4 * CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(x_full + 8 * s, 2);  // the TMA thread and the scan warp
      mbar_init(x_empty + 8 * s, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // the producer: a TMA thread, a scan warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 4 * CONSUMERS && lane == 0) {
      int it = 0;  // heads so far: X stage it % STAGES
      int ic = 0;  // items so far
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++ic) {
        const int z = item / groups;
        const int h0 = (item - z * groups) * hg;
        const int h1 = min(h0 + hg, h);
        mbar_wait(cb_empty, (ic & 1) ^ 1);
        mbar_expect_tx(cb_full, 2 * NH * nt * TILE_BYTES);
        for (int hf = 0; hf < NH; ++hf)
          for (int rt = 0; rt < nt; ++rt) {
            const uint32_t off = (hf * nt + rt) * TILE_BYTES;
            tma_load3(c_s + off, &tmc, cb_full, hf * 64, rt * 64, z);
            tma_load3(b_s + off, &tmb, cb_full, hf * 64, rt * 64, z);
          }
        for (int hh = h0; hh < h1; ++hh, ++it) {
          const int s = it % STAGES;
          mbar_wait(x_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(x_full + 8 * s, nt * TILE_BYTES);
          for (int rt = 0; rt < nt; ++rt)
            tma_load4(x_s + (s * nt + rt) * TILE_BYTES, &tmx, x_full + 8 * s,
                      0, hh, rt * 64, z);
        }
      }
    } else if (warp == 4 * CONSUMERS + 1) {
      // The scan warp: each head's cs2 = (inclusive cumulative sum of
      // dt a) log2 e over the chunk and its dt, into the head's stage:
      // 8 rows a lane, then a shuffle scan over the lanes.  Its dt (h
      // floats apart) is loaded before the stage is free.
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int z = item / groups;
        const int h0 = (item - z * groups) * hg;
        const int h1 = min(h0 + hg, h);
        for (int hh = h0; hh < h1; ++hh, ++it) {
          const int s = it % STAGES;
          float dv[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int row = 8 * lane + r;
            dv[r] = row < q
                        ? dt[(static_cast<long long>(z) * q + row) * h + hh]
                        : 0.f;
          }
          const float ah = a[hh];
          float run = 0.f, inc[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            run += dv[r] * ah;
            inc[r] = run;
          }
          float scan = run;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const float up = __shfl_up_sync(0xffffffffu, scan, d);
            if (lane >= d) scan += up;
          }
          const float before = scan - run;
          float* cs2 = reinterpret_cast<float*>(smem_raw + (w_s - raw)) +
                       s * CS_FLOATS;
          mbar_wait(x_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
#pragma unroll
          for (int r = 0; r < 8; r += 4) {
            *reinterpret_cast<float4*>(cs2 + 8 * lane + r) = make_float4(
                (before + inc[r]) * LOG2E, (before + inc[r + 1]) * LOG2E,
                (before + inc[r + 2]) * LOG2E, (before + inc[r + 3]) * LOG2E);
            *reinterpret_cast<float4*>(cs2 + MAX_Q + 8 * lane + r) =
                make_float4(dv[r], dv[r + 1], dv[r + 2], dv[r + 3]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(x_full + 8 * s);  // releases the rows
        }
      }
    }
    return;  // consumers never use __syncthreads after this point
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wgi = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int lrow = 16 * w4 + g;  // this lane's first row in a row tile
  const unsigned mine = my_tiles(nt, wgi);
  const long long rowstride = static_cast<long long>(h) * p;
  long long* stamps = reinterpret_cast<long long*>(y + wgi * rowstride);
  const bool stamping =
      SSD_PROBE == 7 && blockIdx.x == 0 && w4 == 0 && lane == 0;
#define STAMP(k, slot) \
  if (stamping && (k) < 16) stamps[(k) * STAMPS + (slot)] = clock64()

  int it = 0, ic = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++ic) {
    const int z = item / groups;
    const int h0 = (item - z * groups) * hg;
    const int h1 = min(h0 + hg, h);
    mbar_wait(cb_full, ic & 1);
    for (int hh = h0; hh < h1; ++hh, ++it) {
      const int s = it % STAGES;
      const int kh = ic == 0 ? hh - h0 : 16;  // stamped head
      STAMP(kh, 0);
      mbar_wait(x_full + 8 * s, (it / STAGES) & 1);
      STAMP(kh, 2);
      int tt = 0;  // row tiles taken this head
      const uint32_t xs = x_s + s * nt * TILE_BYTES;
      const float* cs2w = reinterpret_cast<const float*>(
                              smem_raw + (w_s - raw)) + s * CS_FLOATS;
      const float* dtw = cs2w + MAX_Q;
      float* yh = y + static_cast<long long>(z) * q * rowstride +
                  static_cast<long long>(hh) * p;
      for (int i = nt - 1; i >= 0; --i) {
        if (!((mine >> i) & 1)) continue;
        const int sb = 3 + 12 * (tt < 2 ? tt : 1);
        ++tt;
        STAMP(kh, sb);
        const float ci0 = cs2w[64 * i + lrow], ci1 = cs2w[64 * i + lrow + 8];
        float acc[32], sacc[32];
        uint32_t wh[4][4], wl[4][4];
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = 0.f;
        wgmma_fence();
        issue_s<KSTEPS>(sacc, c_s, b_s, nt, i, 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sacc);
        STAMP(kh, sb + 1);
        make_w(sacc, cs2w, dtw, ci0, ci1, i == 0, lrow, t4);
        STAMP(kh, sb + 2);
        pack_w(wh, wl, sacc);
        STAMP(kh, sb + 3);
        // Key tile j: S of tile j + 1 and W X_j go to the tensor cores
        // together; W of tile j + 1 is built while W X_j runs.
        for (int j = 0; j < i; ++j) {
          wgmma_fence();
          issue_s<KSTEPS>(sacc, c_s, b_s, nt, i, j + 1);
          wgmma_commit();
          issue_wx(acc, wh, wl, xs + j * TILE_BYTES);
          wgmma_commit();
          wgmma_wait<1>();  // S of tile j + 1 is in
          reg_fence(sacc);
          if (j == 0) STAMP(kh, sb + 4);
          make_w(sacc, cs2w + 64 * (j + 1), dtw + 64 * (j + 1), ci0, ci1,
                 j + 1 == i, lrow, t4);
          if (j == 0) STAMP(kh, sb + 5);
          wgmma_wait<0>();
          reg_fence(acc);
          if (j == 0) STAMP(kh, sb + 6);
          pack_w(wh, wl, sacc);
          STAMP(kh, sb + 7 + (j < 2 ? j : 2));
        }
        wgmma_fence();
        issue_wx(acc, wh, wl, xs + i * TILE_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
        STAMP(kh, sb + 10);
        // Y straight from the accumulator: the four lanes of a quad write
        // 32 contiguous bytes of a row, a warp 8 rows per store.
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int row = 64 * i + lrow + ((e & 2) ? 8 : 0);
          const int col = 8 * (e >> 2) + 2 * t4;
          if (row < q && col < p && !(SSD_PROBE == 7 && blockIdx.x == 0))
            *reinterpret_cast<float2*>(yh + row * rowstride + col) =
                make_float2(acc[e], acc[e + 1]);
        }
        STAMP(kh, sb + 11);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(x_empty + 8 * s);  // done with X stage s
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(cb_empty);  // done with the item's C and B
  }
#undef STAMP
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
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first, strides in bytes for
// dims 1..rank-1), 128-byte swizzle, zero fill out of bounds.
int make_map(CUtensorMap* map, const void* ptr, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        static_cast<cuuint32_t>(rank), const_cast<void*>(ptr),
                        dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

constexpr int MAX_DEVICES = 64;

int num_sms(int dev) {
  static int known[MAX_DEVICES] = {};
  int& n = known[dev % MAX_DEVICES];
  if (n < 1 && (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                       dev) != cudaSuccess || n < 1))
    n = 132;
  return n;
}

template <int N>
int launch(const void* x, const float* dt, const void* b, const void* c,
           const float* a, float* y, long long bc, long long q, long long h,
           long long p, cudaStream_t stream) {
  constexpr int NH = (N + 63) / 64;
  CUtensorMap mc, mb, mx;
  const cuuint64_t cdims[3] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(q),
                               static_cast<cuuint64_t>(bc)};
  const cuuint64_t cstrides[2] = {static_cast<cuuint64_t>(N * 2),
                                  static_cast<cuuint64_t>(q * N * 2)};
  const cuuint32_t cbox[3] = {64, 64, 1};
  const cuuint64_t xdims[4] = {
      static_cast<cuuint64_t>(p), static_cast<cuuint64_t>(h),
      static_cast<cuuint64_t>(q), static_cast<cuuint64_t>(bc)};
  const cuuint64_t xstrides[3] = {static_cast<cuuint64_t>(p * 2),
                                  static_cast<cuuint64_t>(h * p * 2),
                                  static_cast<cuuint64_t>(q * h * p * 2)};
  const cuuint32_t xbox[4] = {64, 1, 64, 1};
  int e = make_map(&mc, c, 3, cdims, cstrides, cbox);
  if (e == 0) e = make_map(&mb, b, 3, cdims, cstrides, cbox);
  if (e == 0) e = make_map(&mx, x, 4, xdims, xstrides, xbox);
  if (e != 0) return e;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  static bool smem_set[MAX_DEVICES] = {};  // the attribute, per device
  if (err == cudaSuccess && !smem_set[dev % MAX_DEVICES]) {
    err = cudaFuncSetAttribute(ssd_intra_wgmma<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(MAX_Q / 64, NH));
    smem_set[dev % MAX_DEVICES] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // Heads per work item: about one item per SM, so no SM waits on a
  // second round of another's heads.
  const long long sms = SSD_GRID_CAP > 0 && SSD_GRID_CAP < num_sms(dev)
                            ? SSD_GRID_CAP : num_sms(dev);
  long long hg = (bc * h + sms - 1) / sms;
  hg = hg < 1 ? 1 : (hg > h ? h : hg);
  const long long groups = (h + hg - 1) / hg;
  const long long items = bc * groups;
  if (items > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  const int nt = static_cast<int>((q + 63) / 64);
  ssd_intra_wgmma<N><<<grid, THREADS, smem_bytes(nt, NH), stream>>>(
      mc, mb, mx, dt, a, y, static_cast<int>(q), static_cast<int>(h),
      static_cast<int>(p), static_cast<int>(hg), static_cast<int>(groups),
      static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

constexpr int VARIANT_CUDA_CORES = 0, VARIANT_WGMMA = 1;

}  // namespace

// x: (bc, q, h, p) and b, c: (bc, q, n) of one type (dtype 0 = float32,
// 1 = bfloat16); dt: (bc, q, h) and a: (h,) float32; y: (bc, q, h, p)
// float32.  1 <= q <= 256, p in {16, 32, 64}.  variant 0 = CUDA cores
// (either dtype; n >= 1, bc up to 65535), 1 = wgmma + TMA (bfloat16; n in
// {16, 64, 128}; x, b and c 16-byte aligned).  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int ssd_intra_chunk(const void* x, const float* dt, const void* b,
                               const void* c, const float* a, float* y,
                               long long bc, long long q, long long h,
                               long long p, long long n, int dtype,
                               int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  if (q < 1 || q > MAX_Q || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == VARIANT_WGMMA) {
    if (dtype != 1 || (p != 16 && p != 32 && p != 64))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (n) {
      case 16: return tc::launch<16>(x, dt, b, c, a, y, bc, q, h, p, s);
      case 64: return tc::launch<64>(x, dt, b, c, a, y, bc, q, h, p, s);
      case 128: return tc::launch<128>(x, dt, b, c, a, y, bc, q, h, p, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant != VARIANT_CUDA_CORES || bc > 65535 || h > 65535 * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_p<float>(x, dt, b, c, a, y, bc, q, h, p, n, s);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(x, dt, b, c, a, y, bc, q, h, p, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
