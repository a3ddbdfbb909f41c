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
//   1. tile_hist: per-tile pid counts, written partition-major into
//      offs[p * tiles + t];
//   2. tile_scan: each partition row becomes an exclusive scan across
//      tiles plus starts[p], i.e. the first output slot of tile t in p;
//   3. scatter: each tile's tuples to their slots, stably, no atomics.
//
// Bound: bytes.  Each tuple reads pid, rid and key and writes rid and key:
// 20 bytes; tile_hist reads pid once more (24 bytes in all) and the offset
// matrix adds 12 P / tile bytes per tuple.
//
// Fanouts up to SHARED_MAX_PARTS = 2048 partitions (11 bits) take the
// shared-memory path.  A block of 256 threads owns a 4096-tuple tile; its
// 8 warps each take a contiguous 512-tuple sub-range in index order, 32
// tuples a step, and rank each tuple within its step with
// __match_any_sync + popcount against per-(warp, partition) counters in
// shared memory.  A block-wide exclusive scan over the counters in
// (partition, warp) order gives each tuple its slot in the tile sorted by
// pid, input order kept within a partition.  The (rid, key) pairs are
// staged there in shared memory with their output addresses, and a second
// sweep walks the staged tile in order: neighbouring threads write
// neighbouring addresses within each partition's run (32 tuples, 128
// bytes, on average at 128 partitions), where a direct scatter would
// spend one 32-byte sector per 4-byte store.  The loads are coalesced
// 128-byte warp loads, all of a thread's issued before its first use.
//
// Wider fanouts (12 bits and up: 2^17 and 2^18 partitions for a pass
// schedule past 16 bits), whose 8 x P counters would not leave room
// for the staged tile, keep the device-memory path: one warp per tile of
// 8 P tuples walks its tile 32 tuples at a time with the same
// __match_any_sync ranking, its cursors in the tile's own column of offs,
// and stores each tuple straight to its slot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SHARED_MAX_PARTS = 2048;
constexpr int THREADS = 256;             // shared path: one tile per block
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 16;
constexpr int TILE = THREADS * PER_THREAD;   // 4096 tuples
constexpr int SUB = TILE / WARPS;            // 512 tuples per warp
constexpr int WIDE_WARPS = 4;            // device path: tiles per block
constexpr int SCAN_WARPS = 8;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Shared memory of the shared path's scatter: the staged (rid, key) pairs
// and their output addresses, WARPS x P counters and P tile deltas.
size_t scatter_smem(int num_parts) {
  return sizeof(int2) * TILE + sizeof(int32_t) * TILE +
         sizeof(int32_t) * (WARPS + 1) * num_parts;
}

// -- shared path -------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    tile_hist_shared(const int32_t* __restrict__ pid,
                     int32_t* __restrict__ offs, long long n, int num_parts,
                     long long tiles) {
  extern __shared__ int32_t cnt[];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int p = tid; p < num_parts; p += THREADS) cnt[p] = 0;
  __syncthreads();
  const long long t = blockIdx.x;
  const long long lo = t * TILE;
  const int len = static_cast<int>(n - lo < TILE ? n - lo : TILE);
  int v[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int j = k * THREADS + tid;
    v[k] = j < len ? pid[lo + j] : 0;
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const bool valid = k * THREADS + tid < len;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, valid);
    if (valid) {  // one shared atomic per distinct pid of the warp's step
      const unsigned same = __match_any_sync(active, v[k]);
      if (lane == __ffs(same) - 1) atomicAdd(&cnt[v[k]], __popc(same));
    }
  }
  __syncthreads();
  for (int p = tid; p < num_parts; p += THREADS) offs[p * tiles + t] = cnt[p];
}

// One block per partition row: offs[p, :] <- starts[p] + exclusive scan,
// 4 x 256 entries per round, the loads of a round issued together.
__global__ void __launch_bounds__(THREADS)
    tile_scan_rows(int32_t* __restrict__ offs,
                   const int32_t* __restrict__ starts, long long tiles) {
  __shared__ int32_t wsum[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* row = offs + blockIdx.x * tiles;
  int32_t carry = starts[blockIdx.x];
  for (long long base = 0; base < tiles; base += 4 * THREADS) {
    int32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = base + k * THREADS + tid;
      v[k] = i < tiles ? row[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int32_t incl = v[k];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += up;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      int32_t before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int32_t s = wsum[w];
        before += w < warp ? s : 0;
        total += s;
      }
      const long long i = base + k * THREADS + tid;
      if (i < tiles) row[i] = carry + before + incl - v[k];
      carry += total;
      __syncthreads();  // wsum is rewritten next round
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    scatter_shared(const int32_t* __restrict__ rid,
                   const int32_t* __restrict__ key,
                   const int32_t* __restrict__ pid,
                   const int32_t* __restrict__ offs,
                   int32_t* __restrict__ out_rid,
                   int32_t* __restrict__ out_key, long long n,
                   int num_parts, long long tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* stage = reinterpret_cast<int2*>(smem);                 // TILE
  int32_t* dest = reinterpret_cast<int32_t*>(stage + TILE);     // TILE
  int32_t* cnt = dest + TILE;              // [warp][partition], warp-major
  int32_t* delta = cnt + WARPS * num_parts;                     // P
  __shared__ int32_t tsum[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t = blockIdx.x;
  const long long lo = t * TILE;
  const int len = static_cast<int>(n - lo < TILE ? n - lo : TILE);
  for (int e = tid; e < WARPS * num_parts; e += THREADS) cnt[e] = 0;

  // 1. Rank: warp w walks tuples w SUB .. (w + 1) SUB - 1 of the tile in
  // order; rank[k] is the tuple's place among its warp's tuples of its
  // partition.
  const int sub = warp * SUB;
  int pv[PER_THREAD], rank[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int j = sub + 32 * k + lane;
    pv[k] = j < len ? pid[lo + j] : 0;
  }
  __syncthreads();  // counters zeroed
  int32_t* wc = cnt + warp * num_parts;
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const bool valid = sub + 32 * k + lane < len;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, valid);
    unsigned same = 0;
    int32_t c = 0;
    if (valid) {
      same = __match_any_sync(active, pv[k]);
      c = wc[pv[k]];
      rank[k] = c + __popc(same & lt);
    }
    __syncwarp();  // every lane has read its counter before any advances
    if (valid && lane == __ffs(same) - 1) wc[pv[k]] = c + __popc(same);
    __syncwarp();
  }
  __syncthreads();

  // 2. Exclusive scan of the counters in (partition, warp) order: entry
  // e = p * WARPS + w becomes the tile slot of warp w's first tuple of p.
  const int entries = WARPS * num_parts;
  const int per = (entries + THREADS - 1) / THREADS;
  const int e0 = min(tid * per, entries), e1 = min(e0 + per, entries);
  int32_t sum = 0;
  for (int e = e0; e < e1; ++e) sum += cnt[(e % WARPS) * num_parts + e / WARPS];
  int32_t incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) tsum[warp] = incl;
  __syncthreads();
  int32_t run = incl - sum;
  for (int w = 0; w < warp; ++w) run += tsum[w];
  for (int e = e0; e < e1; ++e) {
    const int idx = (e % WARPS) * num_parts + e / WARPS;
    const int32_t c = cnt[idx];
    cnt[idx] = run;
    run += c;
  }
  __syncthreads();
  // delta[p]: output address minus tile slot for partition p's tuples
  // (cnt[p], warp 0's entry, is p's first slot in the tile).
  for (int p = tid; p < num_parts; p += THREADS)
    delta[p] = offs[p * tiles + t] - cnt[p];
  __syncthreads();

  // 3. Stage each (rid, key) at its tile slot with its output address.
  int rv[PER_THREAD], kv[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int j = sub + 32 * k + lane;
    rv[k] = j < len ? rid[lo + j] : 0;
    kv[k] = j < len ? key[lo + j] : 0;
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    if (sub + 32 * k + lane < len) {
      const int slot = cnt[warp * num_parts + pv[k]] + rank[k];
      stage[slot] = make_int2(rv[k], kv[k]);
      dest[slot] = delta[pv[k]] + slot;
    }
  }
  __syncthreads();

  // 4. Write the staged tile in slot order: runs of consecutive addresses.
  for (int j = tid; j < len; j += THREADS) {
    const int2 rk = stage[j];
    const int32_t d = dest[j];
    out_rid[d] = rk.x;
    out_key[d] = rk.y;
  }
}

// -- device-memory path (fanouts above SHARED_MAX_PARTS) ----------------

__global__ void tile_hist_device(const int32_t* __restrict__ pid,
                                 int32_t* __restrict__ offs, long long n,
                                 long long tile, long long tiles) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long t = static_cast<long long>(blockIdx.x) * WIDE_WARPS + warp;
  if (t >= tiles) return;  // whole warps leave together
  const long long lo = t * tile;
  const long long hi = lo + tile < n ? lo + tile : n;
  for (long long base = lo; base < hi; base += 32) {
    const long long i = base + lane;
    const bool valid = i < hi;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, valid);
    if (valid) {
      const int p = pid[i];
      const unsigned same = __match_any_sync(active, p);
      if (lane == __ffs(same) - 1) offs[p * tiles + t] += __popc(same);
    }
    __syncwarp();
  }
}

// One warp per partition row: offs[p, :] <- starts[p] + exclusive scan.
__global__ void tile_scan_warps(int32_t* __restrict__ offs,
                                const int32_t* __restrict__ starts,
                                long long num_parts, long long tiles) {
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

// The warp of tile t walks its tile 32 tuples at a time, in order.
// __match_any_sync groups lanes with the same pid; a lane's rank is the
// popcount of its group below it, and the group's lowest lane advances the
// partition's cursor (offs[p * tiles + t]) after every lane has read it.
__global__ void scatter_device(const int32_t* __restrict__ rid,
                               const int32_t* __restrict__ key,
                               const int32_t* __restrict__ pid,
                               int32_t* __restrict__ offs,
                               int32_t* __restrict__ out_rid,
                               int32_t* __restrict__ out_key, long long n,
                               long long tile, long long tiles) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long t = static_cast<long long>(blockIdx.x) * WIDE_WARPS + warp;
  if (t >= tiles) return;  // whole warps leave together
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
      const int32_t start = offs[p * tiles + t];
      const int32_t d = start + __popc(same & lt);
      out_rid[d] = rid[i];
      out_key[d] = key[i];
      leader = lane == __ffs(same) - 1;
      next = start + __popc(same);
    }
    __syncwarp();  // every lane has read its cursor before any advances
    if (leader) offs[p * tiles + t] = next;
    __syncwarp();
  }
}

}  // namespace

// rid/key/pid: (n,) int32; starts: (2^bits,) int32, the exclusive scan of
// the pid histogram; offs: (2^bits * tiles,) int32 scratch with
// tiles = ceil(n / tile); out_rid/out_key: (n,) int32.  `tile` must be
// 4096 for 2^bits <= 2048 (the shared path) and is the device path's
// tile above.  Every pid must lie in [0, 2^bits).  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int radix_scatter(const int32_t* rid, const int32_t* key,
                             const int32_t* pid, const int32_t* starts,
                             int32_t* offs, int32_t* out_rid,
                             int32_t* out_key, long long n, int bits,
                             long long tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (bits < 0 || bits > 31) return static_cast<int>(cudaErrorInvalidValue);
  const long long num_parts = 1LL << bits;
  const bool shared = num_parts <= SHARED_MAX_PARTS;
  if (tile < 1 || (shared && tile != TILE))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + tile - 1) / tile;
  cudaError_t err;
  if (shared) {
    const int parts = static_cast<int>(num_parts);
    tile_hist_shared<<<static_cast<unsigned>(tiles), THREADS,
                       sizeof(int32_t) * parts, s>>>(pid, offs, n, parts,
                                                     tiles);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    tile_scan_rows<<<parts, THREADS, 0, s>>>(offs, starts, tiles);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    const size_t smem = scatter_smem(parts);
    err = cudaFuncSetAttribute(scatter_shared,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    scatter_shared<<<static_cast<unsigned>(tiles), THREADS, smem, s>>>(
        rid, key, pid, offs, out_rid, out_key, n, parts, tiles);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned blocks =
      static_cast<unsigned>((tiles + WIDE_WARPS - 1) / WIDE_WARPS);
  err = cudaMemsetAsync(offs, 0, sizeof(int32_t) * num_parts * tiles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_hist_device<<<blocks, 32 * WIDE_WARPS, 0, s>>>(pid, offs, n, tile,
                                                      tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  tile_scan_warps<<<static_cast<unsigned>((num_parts + SCAN_WARPS - 1) /
                                          SCAN_WARPS),
                    32 * SCAN_WARPS, 0, s>>>(offs, starts, num_parts, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scatter_device<<<blocks, 32 * WIDE_WARPS, 0, s>>>(
      rid, key, pid, offs, out_rid, out_key, n, tile, tiles);
  return static_cast<int>(cudaGetLastError());
}
