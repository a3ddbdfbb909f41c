// Hash bucket number: murmur3 fmix32 of each key, masked to B buckets.
//
// Replaces the TPU kernel `repro/kernels/hash/hash.py`
// (`hash_bucket_pallas`, body `_hash_kernel`, hash.py:20-28).  For every
// key it writes out = fmix32(uint32(key)) & (B - 1) as int32, B a power of
// two in [1, 2^31]: steps n1/b1/p1 (`bucket_of`, `radix_of(shift=0)`).
//
// Bound: bytes.  Each tuple reads a 4-byte key and writes a 4-byte bucket
// id, so the least time is 8 n bytes over the device memory rate; the hash
// is five integer operations per 8 bytes.  The design is a grid-stride
// loop with neighbouring threads on neighbouring keys, so both streams are
// coalesced, and enough blocks in flight to cover memory latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void hash_kernel(const int32_t* __restrict__ keys,
                            int32_t* __restrict__ out, long long n,
                            uint32_t mask) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = static_cast<int32_t>(fmix32(static_cast<uint32_t>(keys[i])) &
                                  mask);
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

// keys, out: (n,) int32; mask = B - 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int hash_bucket(const int32_t* keys, int32_t* out, long long n,
                           unsigned int mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long want = (n + THREADS - 1) / THREADS;
  const long long cap = 32LL * num_sms();
  const int blocks = static_cast<int>(want < cap ? want : cap);
  hash_kernel<<<blocks, THREADS, 0, s>>>(keys, out, n, mask);
  return static_cast<int>(cudaGetLastError());
}
