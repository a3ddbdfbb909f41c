// CSR probe: the hash join's probe (steps p2 + p3, then p4) over the CSR
// hash table of `repro_torch/core/hash_table.py`, as the PHJ join phase
// (`partitioned_join`), `probe_hash_table` and the variant probes (the
// lookup alone) run it.
//
// Replaces no TPU kernel: the JAX package's probe
// (`repro/core/hash_table.py`: `probe_p2`, `probe_p3`, `probe_p4`) is plain
// `jnp`.  It was added because the plain probe held the benchmark's repeat
// cell: p3 ran a fixed n.bit_length() + 1 = 25 rounds of elementwise torch
// over every probe tuple where a bucket holds about 4 keys, and p4 searched
// the offsets once per output slot (2^26 slots at 2^24).
//
// Three kernels, the inclusive scan of the match counts (`torch.cumsum`)
// between the first two:
//   * `csr_lookup_kernel` (p2 + p3): for probe tuple i, the bucket header
//     (`bstart[b]`, `bcount[b]`, b = bkt[i]) and the leftmost key of the
//     bucket's list not below key[i] as uint32.  `entry[i]` is that key's
//     index when it equals key[i], else -1; `nmatch[i]` its rid count, else
//     0: what `probe_p3` returns, as the lists are sorted as uint32 (and
//     unique) within a bucket, as `table_from_buckets` builds them.
//   * `csr_expand_kernel` (p4): probe i writes its nmatch[i] pairs
//     (rid[i], rids[key_rid_start[entry[i]] + j]) to slots offs[i] -
//     nmatch[i] + j below max_out; slots [total, max_out) get -1, and
//     count = min(total, max_out): the `JoinResult` of `probe_p4`, whose
//     index clamps are kept.  A rid list longer than SPLIT whose first
//     slot lies below max_out is not written here: the probe's index is
//     queued (one warp-aggregated atomic on the queue's length) for the
//     third kernel.  Given a `counters` buffer, it also adds the pairs
//     its probes match (counters[0]), those of lists longer than HEAVY
//     (counters[1]) and of lists longer than SPLIT (counters[3]), and
//     raises counters[2] to the longest rid list one probe tuple matched:
//     from the counts each thread loads anyway, one warp reduction and
//     one atomic each per warp.
//   * `csr_expand_split_kernel`, launched right after on the same stream
//     with a fixed grid, cuts each queued list's slots below max_out
//     into pieces of PIECE slots (at multiples of PIECE) and hands the
//     pieces of all lists to its blocks round robin: a block writes a
//     piece with consecutive threads on consecutive slots, 16-byte stores
//     between its 4-aligned ends.  Slots come from the offsets, so
//     whichever block writes a slot, the output is the same.
//
// Bound: bytes.  At 2^24 x 2^24 with 2^22 buckets and max_out = 2^26 +
// 1088 the lookup reads S's bucket ids and keys (128 MB), the headers
// (32 MB) and the key lists and their rid counts (up to 128 MB) and writes
// entry and nmatch (128 MB): about 416 MB, 0.12 ms at 3.35 TB/s.  The
// expand reads about 384 MB (nmatch, offsets, entries, rids, rid starts and
// rid lists) and writes two max_out slot arrays (537 MB): about 920 MB,
// 0.27 ms.  What the design does about it:
//   * early exit: a bucket's list is scanned up to 4 keys at a time (their
//     loads in flight together) and the scan stops at the first key not
//     below the probe key, so a probe reads about one group of keys, not 25
//     rounds; a list longer than LINEAR_MAX keys is binary-searched;
//   * bucket locality: S is clustered by the same low bits as the buckets,
//     so consecutive probes, and the threads of a block, fall in one
//     partition, whose 2^9 headers (4 KB) and key list (about 8 KB) the
//     neighbouring blocks read from L1 and L2: device memory sees each
//     header and key about once;
//   * three paths by list length, chosen per probe tuple from its match
//     count: a probe with at most HEAVY matches writes them itself, and
//     neighbouring lanes write neighbouring slots; a list of HEAVY + 1 to
//     SPLIT rids is written by the whole warp, 32 slots a round, so a key
//     that matches thousands of build tuples does not serialise one
//     thread and its writes stay coalesced; a longer list is split across
//     the second grid's blocks, so a Zipf key's ~975k rids (30k rounds of
//     one warp, while the rest of the card idles) take the whole card.
//     SPLIT = 2048 is 64 warp rounds, about where one warp's list outlasts
//     an even share of the expand; where no list is longer, nothing is
//     queued and the second launch reads an empty queue and returns;
//   * the slots past the matches, three quarters of the output at 2^24,
//     are filled with 16-byte stores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 4;         // keys of a list in flight together
constexpr int LINEAR_MAX = 16;   // longer lists are binary-searched
constexpr int HEAVY = 8;         // longer rid lists are written by the warp
constexpr int SPLIT = 2048;      // longer ones are split across blocks
constexpr int PIECE = 2048;      // slots of a split list a block writes
constexpr int SPLIT_PER_SM = 4;  // the split grid's blocks per SM
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(THREADS) csr_lookup_kernel(
    const int32_t* __restrict__ bkt, const int32_t* __restrict__ key,
    const int32_t* __restrict__ bstart, const int32_t* __restrict__ bcount,
    const int32_t* __restrict__ ukeys, const int32_t* __restrict__ rcount,
    int32_t* __restrict__ entry, int32_t* __restrict__ nmatch, long long n,
    long long num_buckets, long long num_keys) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t b = static_cast<uint32_t>(__ldg(bkt + i));
    const uint32_t target = static_cast<uint32_t>(__ldg(key + i));
    int32_t e = -1, m = 0;
    if (b < num_buckets) {
      const int32_t s = __ldg(bstart + b);
      const int32_t c = __ldg(bcount + b);
      const int32_t end = s + c;
      if (c > 0 && s >= 0 && end <= num_keys) {
        int32_t lo = s;
        bool found = false;
        if (c <= LINEAR_MAX) {
          for (;;) {
            const int32_t r = end - lo;
            uint32_t k[GROUP];
#pragma unroll
            for (int q = 0; q < GROUP; ++q)
              k[q] = q < r ? static_cast<uint32_t>(__ldg(ukeys + lo + q)) : 0u;
            int below = 0;
#pragma unroll
            for (int q = 0; q < GROUP; ++q) {
              below += (q < r && k[q] < target);
              found |= (q < r && k[q] == target);
            }
            lo += below;
            if (below < GROUP || lo >= end) break;
          }
        } else {
          int32_t hi = end;
          while (lo < hi) {
            const int32_t mid = static_cast<int32_t>(
                (static_cast<uint32_t>(lo) + static_cast<uint32_t>(hi)) >> 1);
            if (static_cast<uint32_t>(__ldg(ukeys + mid)) < target)
              lo = mid + 1;
            else
              hi = mid;
          }
          found = lo < end &&
                  static_cast<uint32_t>(__ldg(ukeys + lo)) == target;
        }
        if (found) {
          e = lo;
          m = __ldg(rcount + lo);
        }
      }
    }
    entry[i] = e;
    nmatch[i] = m;
  }
}

// One output pair at `slot`, below max_out; the rid list index is clamped
// to the table as `probe_p4` clamps it.
__device__ __forceinline__ void put(int32_t* __restrict__ out_probe,
                                    int32_t* __restrict__ out_build,
                                    const int32_t* __restrict__ rids,
                                    long long slot, int32_t pr, long long bp,
                                    long long cap, long long max_out) {
  if (slot < 0 || slot >= max_out) return;
  bp = bp < 0 ? 0 : (bp >= cap ? cap - 1 : bp);
  out_probe[slot] = pr;
  out_build[slot] = cap > 0 ? __ldg(rids + bp) : -1;
}

// The rid at list position bp, clamped as `put` clamps it.
__device__ __forceinline__ int32_t rid_at(const int32_t* __restrict__ rids,
                                          long long bp, long long cap) {
  if (cap <= 0) return -1;
  bp = bp < 0 ? 0 : (bp >= cap ? cap - 1 : bp);
  return __ldg(rids + bp);
}

__global__ void __launch_bounds__(THREADS) csr_expand_kernel(
    const int32_t* __restrict__ prid, const int32_t* __restrict__ entry,
    const int32_t* __restrict__ nmatch, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ rstart, const int32_t* __restrict__ rids,
    int32_t* __restrict__ out_probe, int32_t* __restrict__ out_build,
    int32_t* __restrict__ count, unsigned long long* __restrict__ counters,
    unsigned long long* __restrict__ queue, long long qcap, long long n,
    long long cap, long long max_out) {
  const long long total = n > 0 ? __ldg(offs + n - 1) : 0;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  if (tid == 0) *count = static_cast<int32_t>(total < max_out ? total
                                                               : max_out);
  const int lane = threadIdx.x & 31;
  unsigned long long pairs = 0, heavy_pairs = 0, split_pairs = 0,
                     longest = 0;
  // Warp-uniform trip count: every lane takes part in the ballot.
  for (long long base = tid - lane; base < n; base += threads) {
    const long long i = base + lane;
    int32_t m = 0, pr = 0;
    long long st = 0, rb = 0;
    if (i < n) {
      m = __ldg(nmatch + i);
      const int32_t o = __ldg(offs + i);
      pr = __ldg(prid + i);
      int32_t e = __ldg(entry + i);
      st = static_cast<long long>(o) - m;
      if (m > 0 && cap > 0) {
        e = e < 0 ? 0 : (e >= cap ? static_cast<int32_t>(cap - 1) : e);
        rb = __ldg(rstart + e);
      }
    }
    const bool heavy = m > HEAVY, split = m > SPLIT;
    const unsigned long long um = m > 0 ? static_cast<unsigned>(m) : 0u;
    pairs += um;
    heavy_pairs += heavy ? um : 0;
    split_pairs += split ? um : 0;
    longest = um > longest ? um : longest;
    if (!heavy)
      for (int32_t j = 0; j < m; ++j)
        put(out_probe, out_build, rids, st + j, pr, rb + j, cap, max_out);
    // A split list with a slot below max_out goes to the queue; one past
    // it has nothing to write.
    const unsigned queued = __ballot_sync(FULL, split && st < max_out);
    if (queued) {
      const int first = __ffs(queued) - 1;
      const unsigned long long k = __popc(queued);
      unsigned long long at = 0;
      if (lane == first) at = atomicAdd(queue, k);
      at = __shfl_sync(FULL, at, first) +
           static_cast<unsigned>(__popc(queued & ((1u << lane) - 1u)));
      if ((queued >> lane & 1u) && at < static_cast<unsigned long long>(qcap))
        queue[1 + at] = static_cast<unsigned long long>(i);
    }
    for (unsigned todo = __ballot_sync(FULL, heavy && !split); todo;
         todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const int32_t hm = __shfl_sync(FULL, m, src);
      const int32_t hp = __shfl_sync(FULL, pr, src);
      const long long hs = __shfl_sync(FULL, st, src);
      const long long hb = __shfl_sync(FULL, rb, src);
      const long long stop =
          hs + hm < max_out ? static_cast<long long>(hm) : max_out - hs;
      for (long long j = lane; j < stop; j += 32)
        put(out_probe, out_build, rids, hs + j, hp, hb + j, cap, max_out);
    }
  }
  if (counters != nullptr) {   // every lane of every warp reaches here
    for (int d = 16; d > 0; d >>= 1) {
      pairs += __shfl_down_sync(FULL, pairs, d);
      heavy_pairs += __shfl_down_sync(FULL, heavy_pairs, d);
      split_pairs += __shfl_down_sync(FULL, split_pairs, d);
      const unsigned long long o = __shfl_down_sync(FULL, longest, d);
      longest = o > longest ? o : longest;
    }
    if (lane == 0 && pairs > 0) {
      atomicAdd(counters, pairs);
      if (heavy_pairs > 0) atomicAdd(counters + 1, heavy_pairs);
      atomicMax(counters + 2, longest);
      if (split_pairs > 0) atomicAdd(counters + 3, split_pairs);
    }
  }
  // Slots [total, max_out): -1, with 16-byte stores between the 4-aligned
  // ends a and b (the wrapper's outputs are 16-byte aligned).
  const long long f0 = total > 0 ? total : 0;
  if (f0 >= max_out) return;
  long long a = (f0 + 3) & ~3LL, b = max_out & ~3LL;
  if (a > b) a = b = max_out;
  if (tid < 4) {
    if (f0 + tid < a) out_probe[f0 + tid] = out_build[f0 + tid] = -1;
    if (b + tid < max_out) out_probe[b + tid] = out_build[b + tid] = -1;
  }
  const int4 pad = make_int4(-1, -1, -1, -1);
  int4* op = reinterpret_cast<int4*>(out_probe);
  int4* ob = reinterpret_cast<int4*>(out_build);
  for (long long q = a / 4 + tid; q < b / 4; q += threads) {
    op[q] = pad;
    ob[q] = pad;
  }
}

// Inclusive sum of v over the block's threads (every thread calls it).
__device__ long long block_inclusive_sum(long long v,
                                         long long* __restrict__ warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const long long o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += o;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < THREADS / 32 ? warp_sums[lane] : 0;
    for (int d = 1; d < THREADS / 32; d <<= 1) {
      const long long o = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += o;
    }
    if (lane < THREADS / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  return v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// The lists csr_expand_kernel queued (queue[0] of them, at most qcap, the
// probes' indices from queue[1]), a THREADS-long chunk of the queue at a
// time: each list's slots [st, min(st + m, max_out)) are cut at multiples
// of PIECE, the pieces of the chunk numbered on from the last chunk's,
// and block b writes the pieces numbered b modulo the grid.
__global__ void __launch_bounds__(THREADS) csr_expand_split_kernel(
    const int32_t* __restrict__ prid, const int32_t* __restrict__ entry,
    const int32_t* __restrict__ nmatch, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ rstart, const int32_t* __restrict__ rids,
    int32_t* __restrict__ out_probe, int32_t* __restrict__ out_build,
    const unsigned long long* __restrict__ queue, long long qcap,
    long long cap, long long max_out) {
  __shared__ long long lo[THREADS], hi[THREADS], rb[THREADS], end[THREADS];
  __shared__ int32_t pr[THREADS];
  __shared__ long long warp_sums[THREADS / 32];
  const int t = threadIdx.x;
  const unsigned long long queued = __ldg(queue);
  const long long len =
      queued < static_cast<unsigned long long>(qcap)
          ? static_cast<long long>(queued) : qcap;
  int4* op = reinterpret_cast<int4*>(out_probe);
  int4* ob = reinterpret_cast<int4*>(out_build);
  long long first = 0;   // number of this chunk's first piece
  for (long long c = 0; c < len; c += THREADS) {
    long long pieces = 0;
    if (c + t < len) {
      const long long i = static_cast<long long>(__ldg(queue + 1 + c + t));
      const int32_t m = __ldg(nmatch + i);
      const long long st = static_cast<long long>(__ldg(offs + i)) - m;
      const long long stop = st + m < max_out ? st + m : max_out;
      long long b = 0;
      if (cap > 0) {
        int32_t e = __ldg(entry + i);
        e = e < 0 ? 0 : (e >= cap ? static_cast<int32_t>(cap - 1) : e);
        b = __ldg(rstart + e);
      }
      lo[t] = st;
      hi[t] = stop;
      rb[t] = b;
      pr[t] = __ldg(prid + i);
      pieces = (stop - 1) / PIECE - st / PIECE + 1;
    }
    end[t] = block_inclusive_sum(pieces, warp_sums);
    __syncthreads();
    const long long total = end[THREADS - 1];
    const long long g0 = (first % gridDim.x);
    for (long long k = (blockIdx.x - g0 + gridDim.x) % gridDim.x; k < total;
         k += gridDim.x) {
      int a = 0, z = THREADS - 1;   // the list holding the chunk's piece k
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (end[mid] > k) z = mid; else a = mid + 1;
      }
      const long long st = lo[a], b = rb[a];
      const int32_t p = pr[a];
      const long long piece = st / PIECE + k - (a > 0 ? end[a - 1] : 0);
      const long long s0 = st > piece * PIECE ? st : piece * PIECE;
      const long long s1 =
          hi[a] < (piece + 1) * PIECE ? hi[a] : (piece + 1) * PIECE;
      long long a4 = (s0 + 3) & ~3LL, b4 = s1 & ~3LL;
      if (a4 > b4) a4 = b4 = s1;
      if (t < a4 - s0) put(out_probe, out_build, rids, s0 + t, p,
                           b + s0 + t - st, cap, max_out);
      if (t < s1 - b4) put(out_probe, out_build, rids, b4 + t, p,
                           b + b4 + t - st, cap, max_out);
      for (long long q = a4 / 4 + t; q < b4 / 4; q += THREADS) {
        const long long bp = b + 4 * q - st;
        op[q] = make_int4(p, p, p, p);
        ob[q] = make_int4(rid_at(rids, bp, cap), rid_at(rids, bp + 1, cap),
                          rid_at(rids, bp + 2, cap),
                          rid_at(rids, bp + 3, cap));
      }
    }
    first += total;
    __syncthreads();   // the chunk's lists are read before the next's
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

int blocks_for(long long work, long long per_sm) {
  const long long want = (work + THREADS - 1) / THREADS;
  const long long cap = per_sm * num_sms();
  const long long got = want < cap ? want : cap;
  return static_cast<int>(got > 0 ? got : 1);
}

}  // namespace

// bkt, key, entry, nmatch: (n,) int32; bstart, bcount: (num_buckets,)
// int32; ukeys, rcount: (num_keys,) int32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int csr_lookup(const int32_t* bkt, const int32_t* key,
                          const int32_t* bstart, const int32_t* bcount,
                          const int32_t* ukeys, const int32_t* rcount,
                          int32_t* entry, int32_t* nmatch, long long n,
                          long long num_buckets, long long num_keys,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  csr_lookup_kernel<<<blocks_for(n, 64), THREADS, 0, s>>>(
      bkt, key, bstart, bcount, ukeys, rcount, entry, nmatch, n, num_buckets,
      num_keys);
  return static_cast<int>(cudaGetLastError());
}

// prid, entry, nmatch, offs (the inclusive scan of nmatch): (n,) int32;
// rstart: (num_keys,) int32; rids: (cap,) int32; out_probe, out_build:
// (max_out,) int32, 16-byte aligned; count: () int32; counters: null, or
// (4,) 64-bit counts (pairs, heavy pairs, longest list, split pairs) added
// to; queue: (1 + qcap,) 64-bit, qcap = max_out / SPLIT + 1 (the most
// lists longer than SPLIT that can start below max_out), its length
// zeroed here.  Call csr_expand_split with the same arguments next.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int csr_expand(const int32_t* prid, const int32_t* entry,
                          const int32_t* nmatch, const int32_t* offs,
                          const int32_t* rstart, const int32_t* rids,
                          int32_t* out_probe, int32_t* out_build,
                          int32_t* count, unsigned long long* counters,
                          unsigned long long* queue, long long qcap,
                          long long n, long long cap, long long max_out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(queue, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = n > max_out / 4 ? n : max_out / 4;
  csr_expand_kernel<<<blocks_for(work, 16), THREADS, 0, s>>>(
      prid, entry, nmatch, offs, rstart, rids, out_probe, out_build, count,
      counters, queue, qcap, n, cap, max_out);
  return static_cast<int>(cudaGetLastError());
}

// The lists csr_expand queued, written by SPLIT_PER_SM blocks per SM
// (they return at once on an empty queue).  Arguments as csr_expand's.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int csr_expand_split(const int32_t* prid, const int32_t* entry,
                                const int32_t* nmatch, const int32_t* offs,
                                const int32_t* rstart, const int32_t* rids,
                                int32_t* out_probe, int32_t* out_build,
                                const unsigned long long* queue,
                                long long qcap, long long cap,
                                long long max_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  csr_expand_split_kernel<<<SPLIT_PER_SM * num_sms(), THREADS, 0, s>>>(
      prid, entry, nmatch, offs, rstart, rids, out_probe, out_build, queue,
      qcap, cap, max_out);
  return static_cast<int>(cudaGetLastError());
}
