// Radix-partition steps n1+n2 fused: murmur3 fmix32 radix digit + histogram.
//
// Replaces the TPU kernel `repro/kernels/partition_hist/fused.py`
// (`partition_hist_fused_pallas`, body `_fused_kernel`).  For every key it
// writes pid = (fmix32(key) >> shift) & (2^bits - 1) and adds one to
// hist[pid].  Any digit the JAX package takes: 1 <= bits, shift + bits <=
// 32.  (At bits = 32 a pid with its top bit set is negative as int32, and
// the JAX package's segment_sum does not count it; neither does this.)
//
// Bound: bytes.  Each tuple reads a 4-byte key and writes a 4-byte pid, so
// the least time is 8 n bytes over the device memory rate; the hash is a
// handful of integer operations per 8 bytes.  The design keeps enough
// bytes in flight to reach that rate and keeps histogram traffic off
// device memory:
//   * 16-byte loads and stores: a thread issues U = 4 int4 loads of keys
//     (64 bytes) before it uses the first, and writes its pids as int4;
//     neighbouring threads take neighbouring vectors.  Persistent blocks
//     (as many as fit on the card) walk the keys in strides.  Keys past the
//     last whole vector, and inputs whose pointers are not 16-byte aligned,
//     take a scalar path;
//   * sub-histograms in shared memory: each warp (or each of a few groups
//     of warps, when 16 copies of a wide histogram would not fit) adds to
//     its own copy with plain shared atomics, so warps do not contend on
//     one counter; the copies are summed per block and added to the global
//     histogram once, non-zero bins only;
//   * no __match_any_sync aggregation by default, not even for 1- or
//     2-bit digits where a warp's lanes mostly collide: the shared atomics
//     of per-warp copies measured faster (MATCH_MAX_BITS > 0 builds it for
//     digits up to that width, for comparison);
//   * digits wider than a shared-memory histogram (past SHARED_MAX_BITS,
//     up to 32 bits) add straight into the global histogram.
// The histogram is cleared by a memset before the kernel.  Integer
// addition commutes, so the histogram does not depend on the order of the
// atomics: the result is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MATCH_MAX_BITS
#define MATCH_MAX_BITS 0  // widest digit with match aggregation (0: none)
#endif

namespace {

// Threads per block and int4 loads in flight per thread; other values
// are probing builds of tools/check_hopper_kernels.py.
#ifndef A_THREADS
#define A_THREADS 512
#endif
#ifndef A_U
#define A_U 4
#endif
constexpr int THREADS = A_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int U = A_U;                 // int4 loads in flight per thread
constexpr int SHARED_MAX_BITS = 14;    // 64 KiB of counters
constexpr int SMEM_MAX = 4 << SHARED_MAX_BITS;
constexpr int MODE_MATCH = 0, MODE_SHARED = 1, MODE_GLOBAL = 2;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// One count for pid p (when `valid`).  Every lane of the warp calls it
// together: the match mode's ballot needs the whole warp.
template <int MODE>
__device__ __forceinline__ void count(int32_t* counters, uint32_t p,
                                      bool valid, bool drop_negative) {
  if constexpr (MODE == MODE_MATCH) {
    const unsigned active = __ballot_sync(0xFFFFFFFFu, valid);
    if (valid) {
      const unsigned same = __match_any_sync(active, p);
      if ((threadIdx.x & 31) == __ffs(same) - 1)
        atomicAdd(&counters[p], __popc(same));
    }
  } else if constexpr (MODE == MODE_SHARED) {
    if (valid) atomicAdd(&counters[p], 1);
  } else {
    if (valid && !(drop_negative && static_cast<int32_t>(p) < 0))
      atomicAdd(&counters[p], 1);
  }
}

template <int MODE, bool kVec>
__global__ void __launch_bounds__(THREADS)
    fused_kernel(const int32_t* __restrict__ keys,
                 int32_t* __restrict__ pid_out, int32_t* __restrict__ hist,
                 long long n, int shift, uint32_t mask, int copies) {
  extern __shared__ int32_t sh[];
  constexpr bool kShared = MODE != MODE_GLOBAL;
  const int tid = threadIdx.x;
  const long long bins = static_cast<long long>(mask) + 1;
  if (kShared) {
    for (int i = tid; i < copies * bins; i += THREADS) sh[i] = 0;
    __syncthreads();
  }
  int32_t* counters =
      kShared ? sh + ((tid >> 5) & (copies - 1)) * bins : hist;
  const bool drop_negative = mask == 0xFFFFFFFFu;
  long long done = 0;  // keys the vector path covers
  if (kVec) {
    const int4* k4 = reinterpret_cast<const int4*>(keys);
    int4* p4 = reinterpret_cast<int4*>(pid_out);
    const long long n4 = n >> 2;
    done = n4 << 2;
    const long long step = static_cast<long long>(gridDim.x) * THREADS * U;
    // Every lane of a warp runs the same iterations (the bounds depend on
    // the block only), so the match mode's warp primitives see it whole.
    for (long long base = static_cast<long long>(blockIdx.x) * THREADS * U;
         base < n4; base += step) {
      int4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = base + u * THREADS + tid;
        if (i < n4) v[u] = k4[i];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = base + u * THREADS + tid;
        const bool valid = i < n4;
        int4 o = make_int4(0, 0, 0, 0);
        if (valid) {
          o.x = static_cast<int32_t>((fmix32(v[u].x) >> shift) & mask);
          o.y = static_cast<int32_t>((fmix32(v[u].y) >> shift) & mask);
          o.z = static_cast<int32_t>((fmix32(v[u].z) >> shift) & mask);
          o.w = static_cast<int32_t>((fmix32(v[u].w) >> shift) & mask);
          p4[i] = o;
        }
        count<MODE>(counters, o.x, valid, drop_negative);
        count<MODE>(counters, o.y, valid, drop_negative);
        count<MODE>(counters, o.z, valid, drop_negative);
        count<MODE>(counters, o.w, valid, drop_negative);
      }
    }
  }
  // The scalar path: the keys past the last whole vector (fewer than 4,
  // in block 0), or all of them when the pointers are not aligned.
  const long long first =
      done + (kVec ? 0 : static_cast<long long>(blockIdx.x) * THREADS) +
      (tid & ~31);
  const long long stride =
      kVec ? THREADS : static_cast<long long>(gridDim.x) * THREADS;
  if (!kVec || blockIdx.x == 0) {
    for (long long base = first; base < n; base += stride) {
      const long long i = base + (tid & 31);
      const bool valid = i < n;
      uint32_t p = 0;
      if (valid) {
        p = (fmix32(static_cast<uint32_t>(keys[i])) >> shift) & mask;
        pid_out[i] = static_cast<int32_t>(p);
      }
      count<MODE>(counters, p, valid, drop_negative);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int b = tid; b < bins; b += THREADS) {
      int c = 0;
      for (int k = 0; k < copies; ++k) c += sh[k * bins + b];
      if (c) atomicAdd(&hist[b], c);
    }
  }
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

template <int MODE, bool kVec>
int launch(const int32_t* keys, int32_t* pid, int32_t* hist, long long n,
           int shift, uint32_t mask, int copies, size_t smem,
           cudaStream_t s) {
  auto kernel = fused_kernel<MODE, kVec>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  static bool smem_set[MAX_DEVICES] = {};  // the attribute, per device
  if (e == cudaSuccess && !smem_set[dev % MAX_DEVICES]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    smem_set[dev % MAX_DEVICES] = e == cudaSuccess;
  }
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) per_sm = 1;
  const long long per_block = kVec ? THREADS * 4LL * U : THREADS * 4LL;
  const long long want = (n + per_block - 1) / per_block;
  const long long most = static_cast<long long>(per_sm) * num_sms(dev);
  const int blocks = static_cast<int>(want < most ? want : most);
  kernel<<<blocks, THREADS, smem, s>>>(keys, pid, hist, n, shift, mask,
                                       copies);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(const int32_t* keys, int32_t* pid, int32_t* hist,
                long long n, int shift, uint32_t mask, int copies,
                size_t smem, cudaStream_t s) {
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pid) % 16 == 0;
  return vec ? launch<MODE, true>(keys, pid, hist, n, shift, mask, copies,
                                  smem, s)
             : launch<MODE, false>(keys, pid, hist, n, shift, mask, copies,
                                   smem, s);
}

}  // namespace

// pid: (n,) int32 out; hist: (2^bits,) int32 out (zeroed here).
// 1 <= bits, 0 <= shift, shift + bits <= 32.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int partition_hist_fused(const int32_t* keys, int32_t* pid,
                                    int32_t* hist, long long n, int shift,
                                    int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits < 1 || shift < 0 || shift + bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long bins = 1ULL << bits;
  const uint32_t mask = static_cast<uint32_t>(bins - 1);
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int32_t) * bins, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (bits > SHARED_MAX_BITS)
    return launch_mode<MODE_GLOBAL>(keys, pid, hist, n, shift, mask, 1, 0,
                                    s);
  // As many sub-histograms as fit in SMEM_MAX, up to one per warp (a power
  // of two, so warp w adds to copy w mod copies).
  int copies = WARPS;
  while (copies > 1 && copies * bins * sizeof(int32_t) > SMEM_MAX)
    copies >>= 1;
  const size_t smem = copies * bins * sizeof(int32_t);
  if (bits <= MATCH_MAX_BITS)
    return launch_mode<MODE_MATCH>(keys, pid, hist, n, shift, mask, copies,
                                   smem, s);
  return launch_mode<MODE_SHARED>(keys, pid, hist, n, shift, mask, copies,
                                  smem, s);
}
