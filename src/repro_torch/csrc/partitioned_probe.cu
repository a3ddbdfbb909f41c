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
// least time is (P K + 2 P M + hits) 4 bytes over the device memory rate;
// the search is log2(K) dependent compares per probe key, and they, not
// the bytes, held the kernel before its redesign (one block per row, the
// row staged, then searched: staging and search never overlapped within a
// block).  The design (`ws_kernel`):
//   * one persistent block per SM walks work units (a row, or a row's
//     share of its probe keys when there are too few rows to fill the
//     card) through a ring of 7 shared-memory stages.  A producer warp
//     fills each stage with three TMA 1-D bulk copies (the row's keys, its
//     rids, the unit's probe keys) on an mbarrier, while 6 consumer groups
//     of 5 warps search the units already landed, so staging overlaps the
//     search and no thread issues a copy instruction per 16 bytes;
//   * the top of the search reads a small table: the keys at the first
//     TOP = 6 levels' midpoints ((lo + hi) >> 1 from (0, K); they depend
//     on K only), 63 keys in breadth-first order, gathered by the producer
//     into the stage.  Level d of the table is 2^d consecutive words, so a
//     warp reads it without bank conflicts, where the row's own midpoints
//     (K/2, K/4, 3K/4, ... with K a multiple of 128) fall into few banks.
//     The walk makes exactly the comparisons of the reference's first TOP
//     rounds, on any row; the rest of the search continues in the row;
//   * each thread searches KPT = 4 probe keys at once, branch-free, their
//     reads of a round in flight together: the rounds drop the reference's
//     lo < hi guard, which changes nothing (see search_unit), and run as
//     many times as the widest interval left needs;
//   * the search keeps the key at its upper end, so the lower bound's key
//     is not read again; a match's rid comes from the staged rids, not
//     from device memory (a 32-byte sector for each 4-byte rid).
// Rows that are not 16-byte aligned (K or M not a multiple of 4, or a base
// pointer off 16 bytes), or too long for 6 stages, take the kernel of one
// block per row with only the keys staged (up to max_shared_keys()), and
// a row longer than shared memory holds is searched in device memory
// (through the L2 cache) by the same kernel, its probe keys spread over
// several blocks.
//
// Probing builds (`-D` flags, tools/check_hopper_kernels.py --probe):
// F_TOP sets the table's levels (0 drops it), F_STAGE_RIDS=0 reads the
// rids from device memory, F_KPT sets the probe keys per thread,
// F_WS_STAGES=6 keeps no stage ahead of the 6 groups, and F_WS_GROUPS /
// F_WS_WARPS split the block otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef F_KPT
#define F_KPT 4
#endif
#ifndef F_TOP
#define F_TOP 6
#endif
#ifndef F_STAGE_RIDS
#define F_STAGE_RIDS 1
#endif
#ifndef F_WS_GROUPS
#define F_WS_GROUPS 6
#endif
#ifndef F_WS_WARPS
#define F_WS_WARPS 5
#endif
#ifndef F_WS_STAGES
#define F_WS_STAGES 7
#endif

namespace {

constexpr int THREADS = 256;  // the one-block-per-row kernel
constexpr int KPT = F_KPT;
constexpr int TOP_N = (1 << F_TOP) - 1;
constexpr int TOP_PAD = (TOP_N + 3) & ~3;  // keeps the stages 16-byte aligned
constexpr int RID_ROWS = F_STAGE_RIDS ? 1 : 0;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
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

// One 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The midpoint of node `node` (1 the root, 2n and 2n + 1 the children of
// n) of the reference's search over k keys: the first levels' midpoints
// depend on k only.
__device__ __forceinline__ int table_mid(int node, int k) {
  const int depth = 31 - __clz(node);
  int lo = 0, hi = k;
  for (int b = depth - 1; b >= 0; --b) {
    const int mid = (lo + hi) >> 1;
    if ((node >> b) & 1) lo = mid + 1; else hi = mid;
  }
  return (lo + hi) >> 1;
}

// Searches the staged probe keys [0, jn) of one unit, NT threads of which
// this is thread t, and writes their rids (or -1) to dst.  s_top is the
// table of the first `top` levels' keys, s_keys the row with UINT_MAX at
// k, rids the row's rids (staged, or in device memory).
template <int NT>
__device__ __forceinline__ void search_unit(
    const uint32_t* __restrict__ s_top, const uint32_t* __restrict__ s_keys,
    const int32_t* __restrict__ rids, const int32_t* __restrict__ s_probe,
    int32_t* __restrict__ dst, int jn, int k, int top, int bottom, int t) {
  for (int q0 = 0; q0 * NT < jn; q0 += KPT) {
    int32_t pk[KPT];
    int lo[KPT], hi[KPT], node[KPT];
    uint32_t hk[KPT];  // the key at hi, once hi < k
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      const int j = (q0 + q) * NT + t;
      // A lane past jn searches for 0 in (0, 0): it stays there.
      const bool valid = j < jn;
      pk[q] = valid ? s_probe[j] : 0;
      lo[q] = 0;
      hi[q] = valid ? k : 0;
      hk[q] = 0;
      node[q] = 1;
    }
    // The reference's rounds, without its lo < hi guard: hi only ever
    // takes a midpoint whose key is not below the probe key, so once
    // lo == hi < k the key at lo is not below it and the round keeps
    // (lo, hi); at lo == hi == k the sentinel does the same.  The KPT
    // searches are interleaved, their reads of a round in flight
    // together.  First the table's levels (conflict-free) ...
#pragma unroll
    for (int d = 0; d < F_TOP; ++d) {
      if (d >= top) break;  // the same for the whole block
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        const int mid = (lo[q] + hi[q]) >> 1;
        const uint32_t key = s_top[node[q] - 1];
        const bool go = key < static_cast<uint32_t>(pk[q]);
        lo[q] = go ? mid + 1 : lo[q];
        hi[q] = go ? hi[q] : mid;
        hk[q] = go ? hk[q] : key;
        node[q] = 2 * node[q] + go;
      }
    }
    // ... then the staged row, as many rounds as the widest interval
    // left needs (the leftmost, k >> top keys).
    for (int r = 0; r < bottom; ++r) {
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        const int mid = (lo[q] + hi[q]) >> 1;
        const uint32_t key = s_keys[mid];
        const bool go = key < static_cast<uint32_t>(pk[q]);
        lo[q] = go ? mid + 1 : lo[q];
        hi[q] = go ? hi[q] : mid;
        hk[q] = go ? hk[q] : key;
      }
    }
    // The search ends at lo == hi.  Below k that is the last midpoint
    // that was not below the key, so the key there is hk; at k every key
    // compared was below, key k - 1 last: no match.
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      const int j = (q0 + q) * NT + t;
      const int pos = hi[q];
      const bool hit = j < jn && pos < k &&
                       hk[q] == static_cast<uint32_t>(pk[q]) && pk[q] >= 0;
      if (hit) pk[q] = rids[pos];
      if (j < jn) dst[j] = hit ? pk[q] : -1;
    }
  }
}

constexpr int WS_GROUPS = F_WS_GROUPS;       // consumer groups
constexpr int WS_GT = 32 * F_WS_WARPS;       // threads of a group
constexpr int WS_THREADS = WS_GROUPS * WS_GT + 32;  // + the producer warp

// The warp-specialized kernel: one block per SM, a ring of `stages`
// stages (table, keys + sentinel, rids, probe keys), one producer warp
// that fills them by TMA bulk copies (its lanes gather the table) and
// WS_GROUPS consumer groups of WS_GT threads, group g taking the block's
// units g, g + WS_GROUPS, ...  "full" mbarriers count the producer's 32
// lanes and lane 0's expect_tx (33 arrivals); "empty" ones a group's
// threads.  Rows and probe keys must be 16-byte aligned, k and m
// multiples of 4.
__global__ void __launch_bounds__(WS_THREADS, 1)
    ws_kernel(const int32_t* __restrict__ tkeys,
              const int32_t* __restrict__ trids,
              const int32_t* __restrict__ pkeys, int32_t* __restrict__ out,
              int k, int m, int chunks, int mc, long long units, int top,
              int stages) {
  extern __shared__ __align__(16) uint32_t sh[];
  const int kp = (k + 4) & ~3, mcp = (mc + 3) & ~3;
  const int stage_ints = TOP_PAD + (1 + RID_ROWS) * kp + mcp;
  const uint32_t bars = smem_addr(sh + stages * stage_ints);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bottom = 32 - __clz(k >> top);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 33);
      mbar_init(bars + 8 * (stages + s), WS_GT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Key k of every stage is UINT_MAX (see search_unit).
  for (int s = tid; s < stages; s += WS_THREADS)
    sh[s * stage_ints + TOP_PAD + k] = 0xFFFFFFFFu;
  __syncthreads();
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long count =
      first < units ? (units - first + stride - 1) / stride : 0;

  if (warp == WS_GROUPS * F_WS_WARPS) {  // the producer
    constexpr int TG = TOP_N > 32 ? (TOP_N + 31) / 32 : 1;  // entries a lane
    const int tn = (1 << top) - 1;
    int mids[TG];
#pragma unroll
    for (int e = 0; e < TG; ++e)
      mids[e] = lane + 32 * e < tn ? table_mid(lane + 32 * e + 1, k) : 0;
    for (long long i = 0; i < count; ++i) {
      const int s = static_cast<int>(i % stages);
      const long long u = first + i * stride;
      const long long row = u / chunks;
      const int j0 = static_cast<int>(u % chunks) * mc;
      const int jn = min(mc, m - j0);
      const int32_t* keys = tkeys + row * k;
      // The table's keys into registers before waiting for the stage.
      uint32_t tv[TG];
#pragma unroll
      for (int e = 0; e < TG; ++e)
        tv[e] = lane + 32 * e < tn ? keys[mids[e]] : 0;
      if (i >= stages)
        mbar_wait(bars + 8 * (stages + s),
                  static_cast<uint32_t>((i / stages + 1) & 1));
      uint32_t* st = sh + s * stage_ints;
      const uint32_t full = bars + 8 * s;
      if (lane == 0) {
        mbar_expect_tx(full, 4u * ((1 + RID_ROWS) * k + jn));
        bulk_load(smem_addr(st + TOP_PAD), keys, 4u * k, full);
        if (RID_ROWS)
          bulk_load(smem_addr(st + TOP_PAD + kp), trids + row * k, 4u * k,
                    full);
        bulk_load(smem_addr(st + TOP_PAD + (1 + RID_ROWS) * kp),
                  pkeys + row * m + j0, 4u * jn, full);
      }
#pragma unroll
      for (int e = 0; e < TG; ++e)
        if (lane + 32 * e < tn) st[lane + 32 * e] = tv[e];
      mbar_arrive(full);
    }
  } else {  // a consumer group
    const int g = warp / F_WS_WARPS, t = tid - g * WS_GT;
    for (long long i = g; i < count; i += WS_GROUPS) {
      const int s = static_cast<int>(i % stages);
      const long long u = first + i * stride;
      const long long row = u / chunks;
      const int j0 = static_cast<int>(u % chunks) * mc;
      const int jn = min(mc, m - j0);
      mbar_wait(bars + 8 * s, static_cast<uint32_t>((i / stages) & 1));
      const uint32_t* st = sh + s * stage_ints;
      search_unit<WS_GT>(
          st, st + TOP_PAD,
          RID_ROWS ? reinterpret_cast<const int32_t*>(st + TOP_PAD + kp)
                   : trids + row * k,
          reinterpret_cast<const int32_t*>(st + TOP_PAD + (1 + RID_ROWS) * kp),
          out + row * m + j0, jn, k, top, bottom, t);
      mbar_arrive(bars + 8 * (stages + s));
    }
  }
}

// One block per row (split along y over the probe keys): the keys staged
// in shared memory when kShared, else read from device memory.
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

long long round4(long long x) { return (x + 3) & ~3LL; }

// Shared bytes of one stage of the warp-specialized kernel.
long long ws_stage_bytes(long long k, long long mc) {
  return 4 * (TOP_PAD + (1 + RID_ROWS) * round4(k + 1) + round4(mc));
}

// The warp-specialized kernel, when at least WS_GROUPS stages with units
// of min(m, 4 WS_GT) probe keys fit; returns -1 when they do not.
int launch_ws(const int32_t* tkeys, const int32_t* trids,
              const int32_t* pkeys, int32_t* out, long long p, long long k,
              long long m, int top, cudaStream_t s) {
  const long long optin =
      device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const long long sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long per_stage = optin / WS_GROUPS - 16;
  const long long room = (per_stage - ws_stage_bytes(k, 0)) / 4;
  const long long mc_max = room > 0 ? room & ~3LL : 0;
  const long long least = m < 4 * WS_GT ? m : 4 * WS_GT;
  if (mc_max < least) return -1;
  // Two units per group at least, in chunks of at least WS_GT keys.
  long long chunks = (2 * WS_GROUPS * sms + p - 1) / p;
  const long long chunks_max = (m + WS_GT - 1) / WS_GT;
  if (chunks > chunks_max) chunks = chunks_max;
  const long long need = (m + mc_max - 1) / mc_max;
  if (chunks < need) chunks = need;
  if (chunks < 1) chunks = 1;
  long long mc = round4((m + chunks - 1) / chunks);
  chunks = (m + mc - 1) / mc;
  long long stages = optin / (ws_stage_bytes(k, mc) + 16);
  if (stages > F_WS_STAGES) stages = F_WS_STAGES;
  if (stages < WS_GROUPS) return -1;
  const size_t smem =
      static_cast<size_t>(stages * (ws_stage_bytes(k, mc) + 16));
  cudaError_t e = cudaFuncSetAttribute(
      ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long units = p * chunks;
  const int blocks = static_cast<int>(units < sms ? units : sms);
  ws_kernel<<<blocks, WS_THREADS, smem, s>>>(
      tkeys, trids, pkeys, out, static_cast<int>(k), static_cast<int>(m),
      static_cast<int>(chunks), static_cast<int>(mc), units, top,
      static_cast<int>(stages));
  return static_cast<int>(cudaGetLastError());
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
  // The table's levels: all its nodes hold keys while 2^top - 1 <= k.
  int top = 0;
  while (top < F_TOP && (2LL << top) - 1 <= k) ++top;
  const bool aligned = k % 4 == 0 && m % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(tkeys) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(trids) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(pkeys) % 16 == 0;
  if (aligned) {
    const int err = launch_ws(tkeys, trids, pkeys, out, p, k, m, top, s);
    if (err >= 0) return err;
  }
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
