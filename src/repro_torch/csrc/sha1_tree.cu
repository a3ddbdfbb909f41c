// Tree SHA-1 of device-resident columns: the content key of a relation
// that lies on the card, with only the top digests pulled to the host.
//
// Replaces no TPU kernel: the JAX package's content key
// (`repro/engine/table_cache.py: relation_fingerprint`) is `hashlib.sha1`
// over the relation's bytes on the host.  It was added because that key
// pulled both columns of every fresh relation to the host and hashed them
// there (about 280 ms for a 2^24-row relation on the H100's host) inside
// the join service's G lock.
//
// The format (`repro_torch/kernels/sha1_tree/sha1_tree.py` computes the
// same tree with `hashlib`, its plain version):
//   * a column's bytes are cut into leaves of LEAF_BYTES; the last leaf may
//     be shorter, and an empty column has one empty leaf;
//   * a leaf's digest is the standard SHA-1 of its bytes;
//   * a node's digest is the SHA-1 of up to FANOUT child digests, in
//     order, followed by the byte 0x01.  A node's input is 20 k + 1 bytes
//     long and a leaf's a multiple of 4, so no leaf input is ever a node
//     input;
//   * levels are built until at most TOP_DIGESTS remain (the wrapper plans
//     them); the host hashes those.
// A digest is stored as its 20 bytes in SHA-1's byte order, so a level is
// the byte string the next level hashes.
//
// Bound: integer operations, not bytes.  A 64-byte block costs 80 rounds of
// about five operations (a three-input logic op, two rotates as funnel
// shifts, two three-input adds), 64 schedule words of three (two logic ops
// and a rotate), 16 byte swaps and 5 adds: about 613 operations for 64
// bytes read.  A 2^24-row relation (two 64 MiB columns, 65,536 leaves of
// 17 blocks each) is 1.37e9 operations, 0.082 ms at 132 SMs x 64 int32
// lanes x 1.98 GHz, against 0.040 ms to read its 134 MB at 3.35 TB/s.
// What the design does about it:
//   * one thread a leaf and a fully unrolled compression, so the working
//     state and the 16 schedule words stay in registers and the rotates
//     are single `__funnelshift_l`s;
//   * the message comes in as four 16-byte `ld.global.nc` loads a block
//     when the column is 16-byte aligned (4-byte loads otherwise, e.g. a
//     view that starts 4 bytes into a tensor); the four loads of a block
//     fall in two 32-byte sectors, so device memory is read once;
//   * both columns of a relation go in one launch (grid y), 131,072
//     threads at 2^24 rows, so each level is one launch;
//   * a node thread hashes its FANOUT children (21 blocks) alone: the
//     node levels are 1/64 and 1/4096 of the leaves' work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr long long LEAF_BYTES = 1024;
constexpr long long FANOUT = 64;
constexpr int MAX_COLS = 2;
constexpr uint32_t LEAF_END = 0x80000000u;  // the pad byte 0x80
constexpr uint32_t NODE_END = 0x01800000u;  // the node byte 0x01, then 0x80

// One launch's columns: a leaf launch reads `n` bytes at `in`, a node
// launch `n` child digests; each writes its digests at `out`.
struct Cols {
  const uint32_t* in[MAX_COLS];
  long long n[MAX_COLS];
  uint32_t* out[MAX_COLS];
};

// Column `blockIdx.y`'s fields, picked by a select: indexing the kernel
// parameter by a value known only at run time would copy it to the stack.
struct Col {
  const uint32_t* in;
  long long n;
  uint32_t* out;
};

__device__ __forceinline__ Col this_col(const Cols& cols) {
  const bool second = blockIdx.y != 0;
  return {second ? cols.in[1] : cols.in[0], second ? cols.n[1] : cols.n[0],
          second ? cols.out[1] : cols.out[0]};
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int s) {
  return __funnelshift_l(x, x, s);
}

// A message word: four bytes in SHA-1's (big-endian) order.
__device__ __forceinline__ uint32_t be(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ void compress(uint32_t h[5], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      wt = rotl(w[(t + 13) & 15] ^ w[(t + 8) & 15] ^ w[(t + 2) & 15] ^
                    w[t & 15],
                1);
      w[t & 15] = wt;
    }
    uint32_t f, k;
    if (t < 20) {
      f = (b & c) | (~b & d);
      k = 0x5A827999u;
    } else if (t < 40) {
      f = b ^ c ^ d;
      k = 0x6ED9EBA1u;
    } else if (t < 60) {
      f = (b & c) | (b & d) | (c & d);
      k = 0x8F1BBCDCu;
    } else {
      f = b ^ c ^ d;
      k = 0xCA62C1D6u;
    }
    const uint32_t tmp = rotl(a, 5) + f + e + k + wt;
    e = d;
    d = c;
    c = rotl(b, 30);
    b = a;
    a = tmp;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
}

template <bool VEC>
__device__ __forceinline__ void load_block(const uint32_t* p,
                                           uint32_t w[16]) {
  if (VEC) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 v = __ldg(q + j);
      w[4 * j] = be(v.x);
      w[4 * j + 1] = be(v.y);
      w[4 * j + 2] = be(v.z);
      w[4 * j + 3] = be(v.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = be(__ldg(p + i));
  }
}

// The message's last `r` (< 16) words at `p`, the word `end` (the pad byte,
// after a node's 0x01), zeros and the length in bits: one or two blocks.
__device__ __forceinline__ void finish(uint32_t h[5], const uint32_t* p,
                                       int r, uint32_t end, uint32_t bits) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = i < r ? be(__ldg(p + i)) : (i == r ? end : 0u);
  if (r >= 14) {           // no room for the 8-byte length
    compress(h, w);
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = 0u;
  }
  w[15] = bits;            // a message is at most 1281 bytes: w[14] is 0
  compress(h, w);
}

__device__ __forceinline__ void init(uint32_t h[5]) {
  h[0] = 0x67452301u;
  h[1] = 0xEFCDAB89u;
  h[2] = 0x98BADCFEu;
  h[3] = 0x10325476u;
  h[4] = 0xC3D2E1F0u;
}

__device__ __forceinline__ void store(uint32_t* out, const uint32_t h[5]) {
#pragma unroll
  for (int i = 0; i < 5; ++i) out[i] = be(h[i]);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) sha1_leaf_kernel(Cols cols) {
  const Col col = this_col(cols);
  const long long nbytes = col.n;
  const long long leaves =
      nbytes > 0 ? (nbytes + LEAF_BYTES - 1) / LEAF_BYTES : 1;
  const long long leaf =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (leaf >= leaves) return;
  const long long left = nbytes - leaf * LEAF_BYTES;
  const int len = static_cast<int>(left < LEAF_BYTES ? left : LEAF_BYTES);
  const uint32_t* p = col.in + leaf * (LEAF_BYTES / 4);
  uint32_t h[5];
  init(h);
  uint32_t w[16];
  for (int b = 0; b < (len >> 6); ++b, p += 16) {
    load_block<VEC>(p, w);
    compress(h, w);
  }
  finish(h, p, (len & 63) >> 2, LEAF_END, static_cast<uint32_t>(len) * 8u);
  store(col.out + leaf * 5, h);
}

__global__ void __launch_bounds__(THREADS) sha1_node_kernel(Cols cols) {
  const Col col = this_col(cols);
  const long long count = col.n;
  const long long node =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (node * FANOUT >= count) return;
  const long long left = count - node * FANOUT;
  const int kids = static_cast<int>(left < FANOUT ? left : FANOUT);
  const int words = 5 * kids;
  const uint32_t* p = col.in + node * FANOUT * 5;
  uint32_t h[5];
  init(h);
  uint32_t w[16];
  for (int b = 0; b < (words >> 4); ++b, p += 16) {
    load_block<false>(p, w);
    compress(h, w);
  }
  finish(h, p, words & 15, NODE_END,
         static_cast<uint32_t>(20 * kids + 1) * 8u);
  store(col.out + node * 5, h);
}

Cols make_cols(const void* i0, long long n0, void* o0, const void* i1,
               long long n1, void* o1) {
  Cols cols;
  cols.in[0] = static_cast<const uint32_t*>(i0);
  cols.in[1] = static_cast<const uint32_t*>(i1);
  cols.n[0] = n0;
  cols.n[1] = n1;
  cols.out[0] = static_cast<uint32_t*>(o0);
  cols.out[1] = static_cast<uint32_t*>(o1);
  return cols;
}

}  // namespace

// One column's leaves, or two columns' in one launch (ncols 1 or 2): the
// bytes in0 (n0 of them, a multiple of 4) give max(1, ceil(n0 / 1024))
// digests at out0, 20 bytes each; likewise in1, n1, out1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sha1_tree_leaves(const void* in0, long long n0, void* out0,
                                const void* in1, long long n1, void* out1,
                                int ncols, void* stream) {
  if (ncols < 1 || ncols > MAX_COLS) return static_cast<int>(
      cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cols cols = make_cols(in0, n0, out0, in1, ncols > 1 ? n1 : 0, out1);
  long long most = 1;
  bool aligned = true;
  for (int c = 0; c < ncols; ++c) {
    const long long leaves = (cols.n[c] + LEAF_BYTES - 1) / LEAF_BYTES;
    if (leaves > most) most = leaves;
    aligned = aligned && reinterpret_cast<uintptr_t>(cols.in[c]) % 16 == 0;
  }
  const dim3 grid(static_cast<unsigned>((most + THREADS - 1) / THREADS),
                  ncols);
  if (aligned)
    sha1_leaf_kernel<true><<<grid, THREADS, 0, s>>>(cols);
  else
    sha1_leaf_kernel<false><<<grid, THREADS, 0, s>>>(cols);
  return static_cast<int>(cudaGetLastError());
}

// One level of nodes for one or two columns: the n0 child digests at in0
// give ceil(n0 / 64) node digests at out0; likewise in1, n1, out1 (n1 may
// be 0: that column's tree is done).
extern "C" int sha1_tree_nodes(const void* in0, long long n0, void* out0,
                               const void* in1, long long n1, void* out1,
                               int ncols, void* stream) {
  if (ncols < 1 || ncols > MAX_COLS) return static_cast<int>(
      cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cols cols = make_cols(in0, n0, out0, in1, ncols > 1 ? n1 : 0, out1);
  long long most = 0;
  for (int c = 0; c < ncols; ++c) {
    const long long nodes = (cols.n[c] + FANOUT - 1) / FANOUT;
    if (nodes > most) most = nodes;
  }
  if (most == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>((most + THREADS - 1) / THREADS),
                  ncols);
  sha1_node_kernel<<<grid, THREADS, 0, s>>>(cols);
  return static_cast<int>(cudaGetLastError());
}
