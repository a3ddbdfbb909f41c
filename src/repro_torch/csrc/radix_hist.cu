// Radix-partition step n2 on its own: histogram of a partition-id vector.
//
// Replaces the TPU kernel `repro/kernels/partition_hist/partition_hist.py`
// (`radix_hist_pallas`, body `_hist_kernel`, partition_hist.py:17-26).
// hist[p] counts the pids equal to p for p in [0, P); pids outside that
// range are dropped, as the TPU kernel's one-hot drops them.
//
// Bound: bytes.  Each tuple reads a 4-byte pid and the kernel writes P
// 4-byte counters, so the least time is (4 n + 4 P) bytes over the device
// memory rate.  The design is kernel A's (`partition_hist_fused.cu`)
// without the hash:
//   * warp-aggregated increments: lanes with the same pid are grouped with
//     __match_any_sync and only the lowest lane adds the group's size, so
//     few bins do not serialise 32 lanes on one counter;
//   * up to SMEM_MAX_PARTS bins the counters live in shared memory per
//     block and are merged into the global histogram once per block
//     (non-zero bins only); wider histograms (any number of bins, 2^17 and
//     2^18 for a pass schedule past 16 bits) add straight into global
//     memory.
// Integer addition commutes, so the histogram does not depend on the order
// of the atomics: the result is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_MAX_PARTS = 1 << 13;  // 32 KiB of shared memory

template <bool kShared>
__global__ void hist_kernel(const int32_t* __restrict__ pid,
                            int32_t* __restrict__ hist, long long n,
                            long long num_parts) {
  extern __shared__ int32_t sh[];
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
    const int p = i < n ? pid[i] : -1;
    const bool valid = p >= 0 && p < num_parts;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, valid);
    if (valid) {
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

// pid: (n,) int32; hist: (num_parts,) int32 out (zeroed here), num_parts
// >= 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int radix_hist(const int32_t* pid, int32_t* hist, long long n,
                          long long num_parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(hist, 0, sizeof(int32_t) * num_parts, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long want = (n + THREADS * 8LL - 1) / (THREADS * 8LL);
  const int blocks = static_cast<int>(
      want < 4LL * num_sms() ? want : 4LL * num_sms());
  if (num_parts <= SMEM_MAX_PARTS) {
    hist_kernel<true><<<blocks, THREADS, sizeof(int32_t) * num_parts, s>>>(
        pid, hist, n, num_parts);
  } else {
    hist_kernel<false><<<blocks, THREADS, 0, s>>>(pid, hist, n, num_parts);
  }
  return static_cast<int>(cudaGetLastError());
}
