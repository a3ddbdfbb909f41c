// Radix-partition step n3: stable scatter of (rid, key) into partitions.
//
// Replaces the TPU kernel `repro/kernels/partition_hist/reorder.py`
// (`radix_scatter_pallas`, body `_scatter_kernel`).  Tuple i goes to
//   starts[pid[i]] + (tuples of pid[i] in earlier tiles) + (rank in its tile)
// which is the inverse of a stable sort by pid: the output equals
// rid[argsort(pid, stable)], key[argsort(pid, stable)] bit for bit.
//
// The TPU kernel walks its grid in order and carries the running
// per-partition offsets in VMEM from one tile to the next.  Blocks on
// Hopper run in no order, so the carried state becomes three launches:
//   1. tile_hist: one warp per tile counts its pids, written partition-
//      major into offs[p * tiles + t];
//   2. tile_scan: one warp per partition row turns the row into an
//      exclusive scan across tiles plus starts[p], i.e. the first output
//      slot of tile t in partition p;
//   3. scatter: the warp of tile t walks its tile 32 tuples at a time, in
//      order.  __match_any_sync groups lanes with the same pid; a lane's
//      rank is the popcount of its group below it, and the group's lowest
//      lane advances the partition's cursor after every lane has read it.
//      Lanes and chunks are taken in index order, so equal pids keep their
//      input order: the scatter is stable without atomics.
// Per-tile counters live in shared memory while 4 warps x 2^bits counters
// fit in SMEM_MAX_PARTS; wider digits use the tile's own column of offs in
// device memory (each warp owns its column, so still no atomics).  The
// tile length grows with 2^bits (tile_len in reorder.py) so the (P x tiles)
// offset matrix holds at most about n/8 ints once n exceeds one tile.
//
// Bound: bytes.  Each tuple reads pid, rid, key and writes rid, key: 20
// bytes; tile_hist reads pid once more (4 bytes) and the offset matrix adds
// about 16 P/tile bytes per tuple.  Reads are coalesced 128-byte warp
// loads; the writes scatter into 2^bits open streams, which is the cost the
// pass planner's fanout knee prices.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                // tiles per block
constexpr int SMEM_MAX_PARTS = 2048;    // 4 x 2048 x 4 B = 32 KiB
constexpr int SCAN_WARPS = 8;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

template <bool kShared>
__global__ void tile_hist_kernel(const int32_t* __restrict__ pid,
                                 int32_t* __restrict__ offs, long long n,
                                 int num_parts, long long tile,
                                 long long tiles) {
  extern __shared__ int32_t sh[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long t = static_cast<long long>(blockIdx.x) * WARPS + warp;
  int32_t* cnt = kShared ? sh + warp * num_parts : nullptr;
  if (kShared) {
    for (int p = lane; p < num_parts; p += 32) cnt[p] = 0;
    __syncwarp();
  }
  if (t < tiles) {
    const long long lo = t * tile;
    const long long hi = lo + tile < n ? lo + tile : n;
    for (long long base = lo; base < hi; base += 32) {
      const long long i = base + lane;
      const bool valid = i < hi;
      const unsigned active = __ballot_sync(0xFFFFFFFFu, valid);
      if (valid) {
        const int p = pid[i];
        const unsigned same = __match_any_sync(active, p);
        if (lane == __ffs(same) - 1) {
          if (kShared) cnt[p] += __popc(same);
          else offs[p * tiles + t] += __popc(same);
        }
      }
      __syncwarp();
    }
    if (kShared) {
      for (int p = lane; p < num_parts; p += 32) offs[p * tiles + t] = cnt[p];
    }
  }
}

// One warp per partition row: offs[p, :] <- starts[p] + exclusive scan.
__global__ void tile_scan_kernel(int32_t* __restrict__ offs,
                                 const int32_t* __restrict__ starts,
                                 int num_parts, long long tiles) {
  const int lane = threadIdx.x & 31;
  const long long p =
      static_cast<long long>(blockIdx.x) * SCAN_WARPS + (threadIdx.x >> 5);
  if (p >= num_parts) return;  // whole warps leave together
  int32_t* row = offs + p * tiles;
  int32_t carry = starts[p];
  for (long long base = 0; base < tiles; base += 32) {
    const long long i = base + lane;
    const int32_t v = i < tiles ? row[i] : 0;
    int32_t incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += up;
    }
    if (i < tiles) row[i] = carry + incl - v;
    carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
  }
}

template <bool kShared>
__global__ void scatter_kernel(const int32_t* __restrict__ rid,
                               const int32_t* __restrict__ key,
                               const int32_t* __restrict__ pid,
                               int32_t* __restrict__ offs,
                               int32_t* __restrict__ out_rid,
                               int32_t* __restrict__ out_key, long long n,
                               int num_parts, long long tile,
                               long long tiles) {
  extern __shared__ int32_t sh[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long t = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (t >= tiles) return;  // whole warps leave together
  int32_t* cur = kShared ? sh + warp * num_parts : nullptr;
  if (kShared) {
    for (int p = lane; p < num_parts; p += 32) cur[p] = offs[p * tiles + t];
    __syncwarp();
  }
  const unsigned lt = lanemask_lt();
  const long long lo = t * tile;
  const long long hi = lo + tile < n ? lo + tile : n;
  for (long long base = lo; base < hi; base += 32) {
    const long long i = base + lane;
    const bool valid = i < hi;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, valid);
    int p = 0, next = 0;
    bool leader = false;
    if (valid) {
      p = pid[i];
      const unsigned same = __match_any_sync(active, p);
      int32_t* slot = kShared ? &cur[p] : &offs[p * tiles + t];
      const int32_t start = *slot;
      const int32_t dest = start + __popc(same & lt);
      out_rid[dest] = rid[i];
      out_key[dest] = key[i];
      leader = lane == __ffs(same) - 1;
      next = start + __popc(same);
    }
    __syncwarp();  // every lane has read its cursor before any advances
    if (leader) {
      if (kShared) cur[p] = next;
      else offs[p * tiles + t] = next;
    }
    __syncwarp();
  }
}

}  // namespace

// rid/key/pid: (n,) int32; starts: (2^bits,) int32, the exclusive scan of
// the pid histogram; offs: (2^bits * tiles,) int32 scratch with
// tiles = ceil(n / tile); out_rid/out_key: (n,) int32.  Every pid must lie
// in [0, 2^bits).  Returns the cudaError_t of the launches (0 on success).
extern "C" int radix_scatter(const int32_t* rid, const int32_t* key,
                             const int32_t* pid, const int32_t* starts,
                             int32_t* offs, int32_t* out_rid,
                             int32_t* out_key, long long n, int bits,
                             long long tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int num_parts = 1 << bits;
  const long long tiles = (n + tile - 1) / tile;
  const int blocks = static_cast<int>((tiles + WARPS - 1) / WARPS);
  const bool shared = num_parts <= SMEM_MAX_PARTS;
  const size_t smem = shared ? sizeof(int32_t) * WARPS * num_parts : 0;
  if (shared) {
    tile_hist_kernel<true><<<blocks, 32 * WARPS, smem, s>>>(
        pid, offs, n, num_parts, tile, tiles);
  } else {
    cudaError_t err = cudaMemsetAsync(
        offs, 0, sizeof(int32_t) * num_parts * tiles, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_hist_kernel<false><<<blocks, 32 * WARPS, 0, s>>>(
        pid, offs, n, num_parts, tile, tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_scan_kernel<<<(num_parts + SCAN_WARPS - 1) / SCAN_WARPS,
                     32 * SCAN_WARPS, 0, s>>>(offs, starts, num_parts, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shared) {
    scatter_kernel<true><<<blocks, 32 * WARPS, smem, s>>>(
        rid, key, pid, offs, out_rid, out_key, n, num_parts, tile, tiles);
  } else {
    scatter_kernel<false><<<blocks, 32 * WARPS, 0, s>>>(
        rid, key, pid, offs, out_rid, out_key, n, num_parts, tile, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
