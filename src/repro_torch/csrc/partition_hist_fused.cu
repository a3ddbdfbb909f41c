// Radix-partition steps n1+n2 fused: murmur3 fmix32 radix digit + histogram.
//
// Replaces the TPU kernel `repro/kernels/partition_hist/fused.py`
// (`partition_hist_fused_pallas`, body `_fused_kernel`).  For every key it
// writes pid = (fmix32(key) >> shift) & (2^bits - 1) and adds one to
// hist[pid].
//
// Bound: bytes.  Each tuple reads a 4-byte key and writes a 4-byte pid, so
// the least time is 8 n bytes over the device memory rate; the hash is a
// handful of integer operations per 8 bytes.  The design keeps the memory
// streams coalesced (grid-stride loop, neighbouring threads on neighbouring
// keys) and keeps histogram traffic off device memory:
//   * warp-aggregated increments: lanes with the same pid are grouped with
//     __match_any_sync and only the lowest lane adds the group's size, so a
//     narrow digit (bits = 1) does not serialise 32 lanes on one counter;
//   * up to SMEM_MAX_BITS the counters live in shared memory per block and
//     are merged into the global histogram once per block (non-zero bins
//     only); wider digits (up to 2^16 bins, 256 KiB, more than a block's
//     227 KB of shared memory) add straight into the global histogram.
// Integer addition commutes, so the histogram does not depend on the order
// of the atomics: the result is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_MAX_BITS = 13;  // 8192 bins = 32 KiB of shared memory

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

template <bool kShared>
__global__ void fused_kernel(const int32_t* __restrict__ keys,
                             int32_t* __restrict__ pid_out,
                             int32_t* __restrict__ hist, long long n,
                             int shift, uint32_t mask) {
  extern __shared__ int32_t sh[];
  const int num_parts = static_cast<int>(mask) + 1;
  if (kShared) {
    for (int i = threadIdx.x; i < num_parts; i += blockDim.x) sh[i] = 0;
    __syncthreads();
  }
  int32_t* counters = kShared ? sh : hist;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // Every lane of a warp runs the same number of iterations, so the warp
  // primitives below always see the whole warp arrive.
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          (threadIdx.x & ~31);
  for (long long base = first; base < n; base += stride) {
    const long long i = base + lane;
    const bool valid = i < n;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, valid);
    if (valid) {
      const uint32_t h = fmix32(static_cast<uint32_t>(keys[i]));
      const int p = static_cast<int>((h >> shift) & mask);
      pid_out[i] = p;
      const unsigned same = __match_any_sync(active, p);
      if (lane == __ffs(same) - 1) atomicAdd(&counters[p], __popc(same));
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < num_parts; i += blockDim.x) {
      const int c = sh[i];
      if (c) atomicAdd(&hist[i], c);
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

}  // namespace

// pid: (n,) int32 out; hist: (2^bits,) int32 out (zeroed here).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int partition_hist_fused(const int32_t* keys, int32_t* pid,
                                    int32_t* hist, long long n, int shift,
                                    int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int num_parts = 1 << bits;
  const uint32_t mask = static_cast<uint32_t>(num_parts - 1);
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int32_t) * num_parts, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long want = (n + THREADS * 8LL - 1) / (THREADS * 8LL);
  const int blocks = static_cast<int>(
      want < 4LL * num_sms() ? want : 4LL * num_sms());
  if (bits <= SMEM_MAX_BITS) {
    fused_kernel<true><<<blocks, THREADS, sizeof(int32_t) * num_parts, s>>>(
        keys, pid, hist, n, shift, mask);
  } else {
    fused_kernel<false><<<blocks, THREADS, 0, s>>>(keys, pid, hist, n, shift,
                                                   mask);
  }
  return static_cast<int>(cudaGetLastError());
}
