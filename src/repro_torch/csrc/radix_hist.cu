// Radix-partition step n2 on its own: histogram of a partition-id vector.
//
// Replaces the TPU kernel `repro/kernels/partition_hist/partition_hist.py`
// (`radix_hist_pallas`, body `_hist_kernel`, partition_hist.py:17-26).
// hist[p] counts the pids equal to p for p in [0, P); pids outside that
// range are dropped, as the TPU kernel's one-hot drops them.
//
// Bound: bytes.  Each tuple reads a 4-byte pid and the kernel writes P
// 4-byte counters, so the least time is (4 n + 4 P) bytes over the device
// memory rate.  Its two inputs on the main paths differ: the final headers
// of a partitioned relation (phj_join, the partitioned group-by) see pids
// in runs of about n / P equal values, the partitioned probe's packing sees
// uniform pids.  The design, after kernel A's (`partition_hist_fused.cu`):
//   * 16-byte loads, U = 4 of them in flight per thread, from persistent
//     blocks of 1024 threads (as many as fit on the card); neighbouring
//     lanes take neighbouring vectors, so a warp's step covers 128
//     consecutive pids.  The up to 3 pids before the first 16-byte
//     boundary and the up to 3 after the last whole vector take a scalar
//     path, so a slice such as pid[1:] still reads in vectors;
//   * runs merged before the atomic, without __match_any_sync: a pid that
//     differs from its predecessor in the warp's 128 is a run head; a
//     suffix minimum over the lanes (5 shuffles) gives each lane the next
//     head after it, and only heads add their run's length.  Clustered
//     pids make one atomic per run piece; on uniform pids nearly every pid
//     is a head and the shuffles are all that is added;
//   * up to SHARED_MAX_PARTS bins the counters live in shared memory, in a
//     few copies (warp w adds to copy w mod copies) when they fit in
//     SMEM_BUDGET; each block sums its copies and adds the non-zero bins
//     to the global histogram once, starting at a bin of its own so that
//     blocks do not queue on one address.  Wider histograms (2^17 and
//     2^18 bins for a pass schedule past 16 bits) add straight into global
//     memory, with the same run merging.
// The histogram is cleared by a memset before the kernel.  Integer
// addition commutes, so the histogram does not depend on the order of the
// atomics: the result is deterministic.
//
// Probing builds (`-D` flags, tools/check_hopper_kernels.py --probe):
// E_THREADS, E_U, E_BLOCKS_PER_SM and E_COPIES set the block size,
// vectors in flight, blocks per SM and sub-histogram copies.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef E_THREADS
#define E_THREADS 1024
#endif
#ifndef E_U
#define E_U 4
#endif
#ifndef E_BLOCKS_PER_SM
#define E_BLOCKS_PER_SM 0  // 0: as many as fit
#endif
#ifndef E_COPIES
#define E_COPIES 0  // 0: as many as fit in SMEM_BUDGET, up to one per warp
#endif

namespace {

constexpr int THREADS = E_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int U = E_U;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr long long SHARED_MAX_PARTS = 1 << 15;  // 128 KiB, one copy
constexpr long long SMEM_BUDGET = 64 << 10;      // for several copies
constexpr int SMEM_MAX = 4 * SHARED_MAX_PARTS;

__device__ __forceinline__ void add(int32_t* counters, int p, int c,
                                    long long parts) {
  if (p >= 0 && p < parts) atomicAdd(&counters[p], c);
}

// Counts the four pids of v, the lane's slice of 128 consecutive pids of
// the warp (lane l holds pids 4l .. 4l+3).  The whole warp calls it
// together; a lane past the data passes pids of -1, which count nowhere.
__device__ __forceinline__ void count4(int32_t* counters, int4 v,
                                       long long parts) {
  const int lane = threadIdx.x & 31;
  // Run heads: a pid unlike the one before it (lane 0's first always).
  const int prev = __shfl_up_sync(FULL, v.w, 1);
  const bool h0 = lane == 0 || v.x != prev;
  const bool h1 = v.y != v.x, h2 = v.z != v.y, h3 = v.w != v.z;
  const int base = 4 * lane;
  const int first = h0 ? base : h1 ? base + 1 : h2 ? base + 2
                  : h3 ? base + 3 : 128;
  // The first head at or after each lane, then after it.
  int after = first;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_down_sync(FULL, after, off);
    if (lane + off < 32) after = min(after, o);
  }
  int next = __shfl_down_sync(FULL, after, 1);
  if (lane == 31) next = 128;
  // Each head's run ends at the next head.
  const int e3 = next;
  const int e2 = h3 ? base + 3 : e3;
  const int e1 = h2 ? base + 2 : e2;
  const int e0 = h1 ? base + 1 : e1;
  if (h0) add(counters, v.x, e0 - base, parts);
  if (h1) add(counters, v.y, e1 - base - 1, parts);
  if (h2) add(counters, v.z, e2 - base - 2, parts);
  if (h3) add(counters, v.w, e3 - base - 3, parts);
}

template <bool kShared>
__global__ void __launch_bounds__(THREADS)
    hist_kernel(const int32_t* __restrict__ pid, int32_t* __restrict__ hist,
                long long n, long long parts, int copies) {
  extern __shared__ int32_t sh[];
  const int tid = threadIdx.x;
  if (kShared) {
    for (long long i = tid; i < copies * parts; i += THREADS) sh[i] = 0;
    __syncthreads();
  }
  int32_t* counters = kShared ? sh + ((tid >> 5) % copies) * parts : hist;

  // Pids before the first 16-byte boundary, the vectors, the pids after.
  const long long head = min(
      n, static_cast<long long>(
             ((16 - (reinterpret_cast<uintptr_t>(pid) & 15)) & 15) >> 2));
  const int4* p4 = reinterpret_cast<const int4*>(pid + head);
  const long long n4 = (n - head) >> 2;
  const long long tail = head + 4 * n4;
  const long long step = static_cast<long long>(gridDim.x) * THREADS * U;
  // Every lane of a warp runs the same iterations (the bounds depend on
  // the block only), so count4's shuffles see the whole warp.
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS * U;
       base < n4; base += step) {
    int4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u * THREADS + tid;
      v[u] = i < n4 ? p4[i] : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) count4(counters, v[u], parts);
  }
  if (blockIdx.x == 0) {
    if (tid < head) add(counters, pid[tid], 1, parts);
    if (tail + tid < n) add(counters, pid[tail + tid], 1, parts);
  }

  if (kShared) {
    __syncthreads();
    // Blocks start their merge at bins of their own.
    const long long rot = blockIdx.x * parts / gridDim.x;
    for (long long i = tid; i < parts; i += THREADS) {
      long long b = i + rot;
      if (b >= parts) b -= parts;
      int c = 0;
      for (int k = 0; k < copies; ++k) c += sh[k * parts + b];
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

template <bool kShared>
int launch(const int32_t* pid, int32_t* hist, long long n, long long parts,
           int copies, size_t smem, cudaStream_t s) {
  auto kernel = hist_kernel<kShared>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  static bool smem_set[MAX_DEVICES] = {};  // the attribute, per device
  if (e == cudaSuccess && !smem_set[dev % MAX_DEVICES]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    smem_set[dev % MAX_DEVICES] = e == cudaSuccess;
  }
  // Blocks per SM for the last shared-memory size asked, per device: the
  // query costs the host more than the kernel takes at small n.
  static size_t occ_smem[MAX_DEVICES] = {};
  static int occ_blocks[MAX_DEVICES] = {};
  int per_sm = occ_smem[dev % MAX_DEVICES] == smem + 1
                   ? occ_blocks[dev % MAX_DEVICES] : 0;
  if (e == cudaSuccess && per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
    occ_smem[dev % MAX_DEVICES] = smem + 1;  // 0: nothing asked yet
    occ_blocks[dev % MAX_DEVICES] = per_sm;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (E_BLOCKS_PER_SM > 0 && per_sm > E_BLOCKS_PER_SM)
    per_sm = E_BLOCKS_PER_SM;
  const long long per_block = THREADS * 4LL * U;
  const long long want = (n + per_block - 1) / per_block;
  const long long most = static_cast<long long>(per_sm) * num_sms(dev);
  const int blocks = static_cast<int>(want < 1 ? 1 : want < most ? want
                                                                 : most);
  kernel<<<blocks, THREADS, smem, s>>>(pid, hist, n, parts, copies);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pid: (n,) int32, 4-byte aligned; hist: (num_parts,) int32 out (cleared
// here), num_parts >= 1.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int radix_hist(const int32_t* pid, int32_t* hist, long long n,
                          long long num_parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_parts < 1 || reinterpret_cast<uintptr_t>(pid) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool shared = num_parts <= SHARED_MAX_PARTS;
  cudaError_t err =
      cudaMemsetAsync(hist, 0, sizeof(int32_t) * num_parts, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (!shared) return launch<false>(pid, hist, n, num_parts, 1, 0, s);
  // As many copies as fit in SMEM_BUDGET (at least one), up to one per
  // warp: a power of two, so warp w adds to copy w mod copies.
  int copies = E_COPIES > 0 ? E_COPIES : WARPS;
  while (copies > 1 && copies * num_parts * 4 >
                           (E_COPIES > 0 ? SMEM_MAX : SMEM_BUDGET))
    copies >>= 1;
  return launch<true>(pid, hist, n, num_parts, copies,
                      sizeof(int32_t) * copies * num_parts, s);
}
