// Partitioned probe: steps p2/p3 over a radix-partitioned layout.
//
// Replaces the TPU kernel `repro/kernels/probe/probe.py` (`probe_pallas`,
// body `_probe_kernel`, probe.py:29-50).  Row r of the layout holds one
// partition: `tkeys[r, :]` its build keys sorted as uint32 and padded with
// INT_MAX, `trids[r, :]` their rids, `pkeys[r, :]` its probe keys padded
// with -1.  For every probe key the kernel finds the leftmost position
// whose key is not below it (a uint32 lower bound), clamps it to [0, K-1]
// and writes the rid there when the key is equal and not negative, else -1.
// The search takes the same midpoints as the fixed-iteration search of the
// TPU kernel, so the two agree on any row, sorted or not.
//
// Bound: bytes.  The function reads the (P, K) keys and the (P, M) probe
// keys once, writes the (P, M) rids, and reads one rid per match, so the
// least time is (P K + 3 P M) 4 bytes over the device memory rate; the
// search is log2(K) compares per probe key.  The design keeps the log2(K)
// dependent reads of each search out of device memory: one block per
// partition stages the row's keys in shared memory, where the searches of
// all its threads read them.  A row too long for shared memory is searched
// in device memory (through the L2 cache) by the same kernel, and its probe
// keys are spread over several blocks so that a single long row still
// fills the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool kShared>
__global__ void probe_kernel(const int32_t* __restrict__ tkeys,
                             const int32_t* __restrict__ trids,
                             const int32_t* __restrict__ pkeys,
                             int32_t* __restrict__ out, int k, int m) {
  extern __shared__ uint32_t s_keys[];
  const long long row = blockIdx.x;
  const uint32_t* keys =
      reinterpret_cast<const uint32_t*>(tkeys + row * k);
  if (kShared) {
    for (int i = threadIdx.x; i < k; i += blockDim.x) s_keys[i] = keys[i];
    __syncthreads();
    keys = s_keys;
  }
  const int32_t* rids = trids + row * k;
  const int32_t* probe = pkeys + row * m;
  int32_t* dst = out + row * m;
  for (int j = blockIdx.y * blockDim.x + threadIdx.x; j < m;
       j += gridDim.y * blockDim.x) {
    const int32_t pk = probe[j];
    const uint32_t target = static_cast<uint32_t>(pk);
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);  // == (lo + hi) >> 1, no overflow
      if (keys[mid] < target) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int pos = lo < k ? lo : k - 1;
    dst[j] = (keys[pos] == target && pk >= 0) ? rids[pos] : -1;
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

}  // namespace

// The longest row (in keys) that the kernel stages in shared memory on the
// current device; longer rows are searched in device memory.
extern "C" long long partitioned_probe_max_shared_keys() {
  return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin) /
         static_cast<long long>(sizeof(uint32_t));
}

// tkeys, trids: (p, k) int32; pkeys, out: (p, m) int32; 1 <= k < 2^31.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int partitioned_probe(const int32_t* tkeys, const int32_t* trids,
                                 const int32_t* pkeys, int32_t* out,
                                 long long p, long long k, long long m,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 0 || m == 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || k > 0x7FFFFFFFLL || m > 0x7FFFFFFFLL || p > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // Blocks along y split a row's probe keys when there are too few rows
  // to fill the card.
  const long long sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long want_y = (4 * sms + p - 1) / p;
  const long long per_row = (m + THREADS - 1) / THREADS;
  long long ny = want_y < per_row ? want_y : per_row;
  if (ny > 65535) ny = 65535;
  if (ny < 1) ny = 1;
  const dim3 grid(static_cast<unsigned>(p), static_cast<unsigned>(ny));
  const size_t bytes = static_cast<size_t>(k) * sizeof(uint32_t);
  if (k <= partitioned_probe_max_shared_keys()) {
    if (bytes > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          probe_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    probe_kernel<true><<<grid, THREADS, bytes, s>>>(
        tkeys, trids, pkeys, out, static_cast<int>(k), static_cast<int>(m));
  } else {
    probe_kernel<false><<<grid, THREADS, 0, s>>>(
        tkeys, trids, pkeys, out, static_cast<int>(k), static_cast<int>(m));
  }
  return static_cast<int>(cudaGetLastError());
}
