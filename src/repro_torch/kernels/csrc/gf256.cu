// GF(2^8) coding kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// These replace the Pallas kernels of the JAX package's coding data plane
// (kernels/gf256_matmul.py and kernels/delta_update.py):
//
//   gf_matmul_batched       <- _gf_matmul_batched_kernel  (strategy unroll)
//   gf_matmul_cols_batched  <- _gf_matmul_cols_kernel     (strategy cols)
//   gf01_matmul_batched     <- _gf01_matmul_kernel        (strategy gf01)
//   gf_per_item             <- _per_item_kernel
//   gf_per_item_fold        <- _per_item_fold_kernel
//   gf_delta_apply_batched  <- _delta_apply_batched_kernel
//   gf_delta_only_batched   <- _delta_only_batched_kernel
//   gf_matmul               <- _gf_matmul_kernel          (single stripe)
//   gf_delta_update         <- _delta_kernel              (single stripe)
//   gf_cuckoo_probe         <- kernels/cuckoo_lookup.py:_probe_kernel
//
// The Pallas bodies decompose every product into 8 bit-planes because the
// TPU's vector unit cannot gather bytes.  Here a GF(2^8) product is a
// lookup: every kernel but the probe looks bytes up four at a time with
// __byte_perm in two 16-entry nibble tables of its coefficient, six
// registers a coefficient (see "Coefficients by value" below).  Kernels
// 4-7 and 9 build the tables in registers; kernels 1, 2 and 8 get them
// built by the host, once per matrix, in their launch parameters.  A 0/1
// coefficient needs no table at all: 1*x is a select, so
// gf01_matmul_batched is pure XOR over the set bits of each matrix row
// (packed into 32-bit masks, walked with __ffs), the per-item kernels walk
// 0/1 rows the same way (the RDP deltas and seal folds are 0/1), and every
// nibble-table kernel XORs whole 16-byte vectors when g = 1.  No kernel
// stages a table in shared memory, and no wrapper copies coefficients to
// the card on the main path.
//
// Every kernel moves 16 bytes a thread: when C is a multiple of 16 and
// every pointer is 16-byte aligned the bytes move as one 16-byte vector
// load/store; otherwise (C = 1000, say) the same loop runs a byte at a
// time and masks the ragged tail.
//
// Bound: each kernel moves every input byte once and every output byte
// once; at the shapes of the coding path the floor is device-memory
// bandwidth, or for the larger shared matrices the integer issue rate of
// the nibble products (see their note).
//
// The index probe has a note of its own beside its kernel below.
//
// Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;
// unroll kernel (1): the most coefficients of its shared (m, k) matrix
// (its tables, 24 bytes a coefficient, always fit a parameter tier)
constexpr int kMaxCoefs = 896;
// column-loop kernel (2): the most coefficients of its matrix
constexpr int kColsMaxCoefs = 32768;
// 0/1 kernel: shared memory for one (K, lanes*16) input tile; at one
// lane a row takes 16 bytes, so K may reach kGf01Smem / 16 columns
constexpr int kGf01Smem = 96 * 1024;
constexpr int kGf01MaxCols = kGf01Smem / kVec;
// single-stripe delta: the m gammas travel in the kernel parameters
constexpr int kDeltaMaxRows = 256;

union V16 {
  uint4 q;
  uint8_t b[kVec];
};

__device__ __forceinline__ V16 load16(const uint8_t* __restrict__ p, int nb,
                                      bool vec) {
  V16 v;
  if (vec) {
    v.q = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v.b[j] = j < nb ? __ldg(p + j) : 0;
  }
  return v;
}

__device__ __forceinline__ void store16(uint8_t* __restrict__ p, const V16& v,
                                        int nb, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = v.q;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < nb) p[j] = v.b[j];
  }
}

__device__ __forceinline__ void xor16(V16& acc, const V16& x) {
  acc.q.x ^= x.q.x;
  acc.q.y ^= x.q.y;
  acc.q.z ^= x.q.z;
  acc.q.w ^= x.q.w;
}

// ---------------------------------------------------------------------------
// Coefficients by value: the per-item kernels (4, 5), the batched delta
// kernels (6, 7) and the single-stripe delta (9).
//
// Replace gf256_matmul.py:_per_item_kernel / _per_item_fold_kernel and
// delta_update.py:_delta_apply_batched_kernel / _delta_only_batched_kernel
// / _delta_kernel.
// On the main path these run at B <= 64 (a YCSB window): a seal fold is
// (64, 1, 1) x 4 KB or (64, 16, 16) x 256 B, a sealed UPDATE (64, 2) x
// 4 KB, under a megabyte each.  So a call is bound by launch latency and
// the wrapper's host work, not by the 3.35 TB/s that bounds it at
// B = 4096.  The design takes everything off that path that is not an
// operand load:
//
//   * Coefficients by value.  The gammas (B*m bytes), the per-item
//     matrices (B*O*J bytes) or, for 0/1 matrices, their row masks
//     (ceil(J/8) bytes per output row, bit j set where M[o, j] = 1) travel
//     in a __grid_constant__ parameter struct.  The wrapper makes no copy
//     to the card and so never waits on the stream.  The struct comes in
//     three sizes (kCoefTiers, kernels/coefs.py TIERS) so a small call
//     does not push 32 KB of parameters; a batch whose coefficients
//     exceed the largest is split by the wrapper into launches of whole
//     items.
//   * No prologue.  A product g*x is built in registers: the thread makes
//     the nibble tables L[i] = g*i and H[i] = g*16i (xtime doubling, POLY
//     0x11D, as the reference's _scaled_rows and _per_item_acc step
//     through g's powers) and looks up four bytes at a time with
//     __byte_perm: g*x = L[x & 15] ^ H[x >> 4].  Each table is one 8-byte
//     half for the nibble's low three bits plus g*8 (or g*128) where bit 3
//     is set, since L[8 + i] = L[i] ^ L[8]: six registers a coefficient.
//     No EXP/LOG in shared memory, no __syncthreads, no table buffer
//     argument.
//   * A grid that fills the card.  One thread owns one 16-byte vector of
//     one row (kernel 6/7: of the xor, for all m parity rows; kernel 4/5:
//     of one (item, output row) pair) and blocks are 64 threads, so at
//     B = 64 each of the three seal/update shapes is 256 blocks for the
//     132 SMs.  Above kBlocksPerSm blocks an SM the grid walks its units
//     grid-stride.
//   * Loads in flight together.  Operands are loaded kGroup at a time
//     (the parity rows of a group, or the input rows of a group of set
//     bits or nonzero coefficients) before any is used, so a thread waits
//     for device memory once per group, not once per row.  0/1 matrices
//     (row masks) run their own instantiation, which needs no table
//     registers (40-48 registers against 55-63 for general matrices).
//
// Bound: bytes, each input read once and each output written once:
// (2m+1)*C per item for the delta with parity, (m+1)*C without; for the
// per-item fold (2O + J)*C, without parity (O + J)*C; for the
// single-stripe delta (2m+2)*C.
// ---------------------------------------------------------------------------

constexpr int kCoefTiers[3] = {512, 4096, 32640};
// one thread a 16-byte vector, 64 threads a block: at B = 64 the main
// path's shapes are 256 blocks for the 132 SMs
constexpr int kSmallThreads = 64;
// operand loads a thread issues together; 2 keeps the delta kernel with
// parity at 72 registers (4: 96 registers, and 0.042 against 0.033 ms at
// B = 4096 on an H100, scripts/by_value_variants.py)
constexpr int kGroup = 2;
// grid cap in blocks per SM; larger grids walk their units grid-stride
constexpr int kBlocksPerSm = 32;

template <int N>
struct CoefBytes {
  uint8_t b[N];
};

__device__ __forceinline__ uint32_t xtime(uint32_t v) {
  const uint32_t d = v << 1;
  return d ^ ((d >> 8) * 0x11Du);
}

// The bytes of one word w as __byte_perm selectors: for the low and the
// high nibble of each byte, its low three bits as selector nibbles (one
// per byte, in order) and its bit 3 as a byte mask.
struct Sel4 {
  uint32_t lo, hi;    // selectors: low / high nibbles, bits 0-2
  uint32_t lo8, hi8;  // 0xFF in each byte whose low / high nibble is >= 8
};

// four byte values < 8 -> a 16-bit selector of those values in order
// (bytes 0 and 2 of n | n >> 4 hold nibbles 0,1 and 2,3)
__device__ __forceinline__ uint32_t selector(uint32_t n) {
  return __byte_perm(n | (n >> 4), 0u, 0x0020u);
}

__device__ __forceinline__ Sel4 nib_select(uint32_t w) {
  Sel4 s;
  s.lo = selector(w & 0x07070707u);
  s.hi = selector((w >> 4) & 0x07070707u);
  s.lo8 = ((w >> 3) & 0x01010101u) * 0xFFu;
  s.hi8 = ((w >> 7) & 0x01010101u) * 0xFFu;
  return s;
}

// The products of g with a nibble, from g's doublings p_j = g * 2^j:
// l0, l1 hold g*i for i < 8 (one per byte), l8 holds g*8 in every byte;
// h0, h1, h8 the same for g*16.  g*x = l[x & 7] ^ (x & 8 ? g*8) ^
// h[(x >> 4) & 7] ^ (x & 128 ? g*128).
struct Nib {
  uint32_t l0, l1, l8;
  uint32_t h0, h1, h8;
};

__device__ __forceinline__ Nib nib_tables(uint32_t g) {
  uint32_t p[8];
  p[0] = g;
#pragma unroll
  for (int j = 1; j < 8; ++j) p[j] = xtime(p[j - 1]);
  Nib t;
  t.l0 = (p[0] << 8) | (p[1] << 16) | ((p[0] ^ p[1]) << 24);
  t.l1 = t.l0 ^ (p[2] * 0x01010101u);
  t.l8 = p[3] * 0x01010101u;
  t.h0 = (p[4] << 8) | (p[5] << 16) | ((p[4] ^ p[5]) << 24);
  t.h1 = t.h0 ^ (p[6] * 0x01010101u);
  t.h8 = p[7] * 0x01010101u;
  return t;
}

// g * the four bytes of the word that s was made from
__device__ __forceinline__ uint32_t gf_mul4(const Sel4& s, const Nib& t) {
  return __byte_perm(t.l0, t.l1, s.lo) ^ (s.lo8 & t.l8) ^
         __byte_perm(t.h0, t.h1, s.hi) ^ (s.hi8 & t.h8);
}

// acc ^= g * x over 16 bytes, for any g
__device__ __forceinline__ void mul_xor16(V16& acc, const V16& x, uint32_t g) {
  if (g == 0) return;
  if (g == 1) {
    xor16(acc, x);
    return;
  }
  const Nib t = nib_tables(g);
  acc.q.x ^= gf_mul4(nib_select(x.q.x), t);
  acc.q.y ^= gf_mul4(nib_select(x.q.y), t);
  acc.q.z ^= gf_mul4(nib_select(x.q.z), t);
  acc.q.w ^= gf_mul4(nib_select(x.q.w), t);
}

__device__ __forceinline__ V16 zero16() {
  V16 v;
  v.q = make_uint4(0u, 0u, 0u, 0u);
  return v;
}

// out[b, o] = (P[b, o] ^) XOR_j M[b, o, j] * D[b, j]; D (B, J, C), P and
// out (B, O, C).  M is the (B, O, J) matrices as bytes (MASKS = false) or
// their 0/1 rows as masks of mask_bytes bytes each.  HAS_PARITY = false is
// the plain per-item product (kernel 4).  Unit t is vector t % vecs of
// pair t / vecs = b * O + o.
template <bool HAS_PARITY, bool MASKS, int N>
__global__ void __launch_bounds__(kSmallThreads)
per_item_kernel(const __grid_constant__ CoefBytes<N> M, int mask_bytes,
                const uint8_t* __restrict__ P, const uint8_t* __restrict__ D,
                uint8_t* __restrict__ out, int B, int O, int J, long long C,
                long long vecs, bool vec) {
  const long long units = (long long)B * O * vecs;
  for (long long t = (long long)blockIdx.x * kSmallThreads + threadIdx.x;
       t < units; t += (long long)gridDim.x * kSmallThreads) {
    const long long pair = t / vecs;
    const long long c0 = (t - pair * vecs) * kVec;
    const int nb = (int)min((long long)kVec, C - c0);
    const uint8_t* d = D + (pair / O) * J * C + c0;
    V16 acc = HAS_PARITY ? load16(P + pair * C + c0, nb, vec) : zero16();
    if (MASKS) {
      uint32_t bits = 0u;
      for (int k = 0; k < mask_bytes; ++k)
        bits |= (uint32_t)M.b[pair * mask_bytes + k] << (8 * k);
      while (bits) {
        V16 x[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          x[i] = zero16();
          if (bits) {
            const int j = __ffs(bits) - 1;
            bits &= bits - 1;
            x[i] = load16(d + (long long)j * C, nb, vec);
          }
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) xor16(acc, x[i]);
      }
    } else {
      const long long row = pair * J;
      for (int j0 = 0; j0 < J; j0 += kGroup) {
        V16 x[kGroup];
        uint32_t g[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          g[i] = j0 + i < J ? (uint32_t)M.b[row + j0 + i] : 0u;
          x[i] = g[i] ? load16(d + (long long)(j0 + i) * C, nb, vec)
                      : zero16();
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) mul_xor16(acc, x[i], g[i]);
      }
    }
    store16(out + pair * C + c0, acc, nb, vec);
  }
}

// out[b, r] = (P[b, r] ^) G[b, r] * X[b]; G (B, m) bytes, X (B, C), P and
// out (B, m, C).  HAS_PARITY = false is the delta-only body (kernel 7);
// OLD_NEW reads X ^ X2 in place of X (kernel 9: old and new, formed in
// registers and never stored).  Unit t is vector t % vecs of item
// t / vecs, for all m rows.
template <bool HAS_PARITY, bool OLD_NEW, int N>
__device__ __forceinline__ void delta_rows(const CoefBytes<N>& G,
                                           const uint8_t* __restrict__ P,
                                           const uint8_t* __restrict__ X,
                                           const uint8_t* __restrict__ X2,
                                           uint8_t* __restrict__ out, int B,
                                           int m, long long C, long long vecs,
                                           bool vec) {
  const long long units = (long long)B * vecs;
  for (long long t = (long long)blockIdx.x * kSmallThreads + threadIdx.x;
       t < units; t += (long long)gridDim.x * kSmallThreads) {
    const long long b = t / vecs;
    const long long c0 = (t - b * vecs) * kVec;
    const int nb = (int)min((long long)kVec, C - c0);
    V16 x = load16(X + b * C + c0, nb, vec);
    if constexpr (OLD_NEW) xor16(x, load16(X2 + b * C + c0, nb, vec));
    for (int r0 = 0; r0 < m; r0 += kGroup) {
      V16 acc[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        acc[i] = HAS_PARITY && r0 + i < m
                     ? load16(P + (b * m + r0 + i) * C + c0, nb, vec)
                     : zero16();
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (r0 + i < m) {
          mul_xor16(acc[i], x, G.b[b * m + r0 + i]);
          store16(out + (b * m + r0 + i) * C + c0, acc[i], nb, vec);
        }
      }
    }
  }
}

// kernels 6 (HAS_PARITY) and 7
template <bool HAS_PARITY, int N>
__global__ void __launch_bounds__(kSmallThreads)
delta_batched_kernel(const __grid_constant__ CoefBytes<N> G,
                     const uint8_t* __restrict__ P,
                     const uint8_t* __restrict__ X, uint8_t* __restrict__ out,
                     int B, int m, long long C, long long vecs, bool vec) {
  delta_rows<HAS_PARITY, false>(G, P, X, nullptr, out, B, m, C, vecs, vec);
}

// Kernel 9, the single-stripe fused delta out[r] = P[r] ^ g[r] * (old ^
// new), P and out (m, C), old and new (C,): kernel 6's body at B = 1 with
// the xor of old and new formed in registers, so the call moves
// (2m + 2) * C bytes (an `old ^ new` pass before kernel 6 would move 3 * C
// more).  The m <= kDeltaMaxRows gammas always fit the smallest tier.
// At C = 4 KB the grid is four 64-thread blocks, at 1 MiB 1,024.
static_assert(kDeltaMaxRows <= kCoefTiers[0], "kernel 9's gammas, one tier");
__global__ void __launch_bounds__(kSmallThreads)
delta_update_kernel(const __grid_constant__ CoefBytes<kCoefTiers[0]> G,
                    const uint8_t* __restrict__ P,
                    const uint8_t* __restrict__ old,
                    const uint8_t* __restrict__ nw, uint8_t* __restrict__ out,
                    int m, long long C, long long vecs, bool vec) {
  delta_rows<true, true>(G, P, old, nw, out, 1, m, C, vecs, vec);
}

// ---------------------------------------------------------------------------
// Shared-matrix products by value: kernels 1 and 2, and kernel 8 (kernel
// 1's launcher at B = 1).
//
// Replace gf256_matmul.py:_gf_matmul_batched_kernel (strategy unroll),
// _gf_matmul_cols_kernel (strategy cols) and _gf_matmul_kernel (the single
// stripe of kernels/ops.py): out[b, r] = XOR_i A[r, i] * D[b, i] over
// GF(2^8) for one (m, k) matrix that every item shares; D (B, k, C), out
// (B, m, C).  RS/XOR encode and every fused decode of a fail_server
// recovery run here, at B = 64 (a YCSB window) up to a recovery batch of
// hundreds to thousands of stripes.  The design is the by-value one
// above, applied to a matrix shared across the batch:
//
//   * Tables by value, built once per matrix.  The host computes each
//     coefficient's six Nib words (l0, l1, l8, h0, h1, h8: 24 bytes, what
//     nib_tables computes; kernels/coefs.py matrix_tables, cached per
//     matrix) and they travel in a __grid_constant__ struct of the
//     kCoefTiers sizes: 1,920 B at (10, 8) and 3,360 B at (14, 10), both
//     in the 4,096-byte tier.  Every thread of a warp reads the same
//     coefficient at the same time: a broadcast from the parameter bank.
//     No shared-memory table, no prologue, no __syncthreads, and the MUL
//     table buffer is no longer an argument.
//   * Matrices beyond the largest tier (above 1,360 coefficients, e.g.
//     (64, 64); no main-path matrix comes near) take their tables from a
//     device buffer that the wrapper copies to the card once per matrix
//     and caches, never once per call; the kernel reads it with uniform
//     loads.  (Reading only l0 there and building the rest with nib_tables
//     in the thread was slower: 7.69 against 5.94 ms for a (64, 64)
//     matrix at B = 1024 on an NVIDIA H100 80GB HBM3 at 700 W.)
//   * Coefficient 0 is skipped and 1 is a plain XOR: l0 is 0 for g = 0
//     and kNibOne for g = 1, so one word decides, a branch uniform over
//     the warp.
//   * Inputs read once.  One thread owns one 16-byte vector of one item.
//     It walks the k inputs outermost, kGroup loads in flight together,
//     makes each input word's Sel4 selectors once and XORs the input's
//     products into every output row it holds: 4 registers a row.  When
//     the batch fills the card (B * C / 16 vectors >= kFillThreads an SM)
//     a thread holds kMat1Rows = 10 rows (kernel 1: an RS(10,8) decode in
//     one pass) or kMat2Rows = 7 (kernel 2: an RS(14,10) decode in two
//     passes over its inputs, the second from L1/L2), or 2 or 4 for a
//     matrix of at most 2 or 4 rows.
//   * A grid that fills the card.  One unit a thread, 64-thread blocks,
//     grid-stride past kBlocksPerSm blocks an SM.  A batch too small to
//     fill the card (B = 64 at C = 4 KB is 16,384 vectors) gives each
//     thread two rows and puts the row groups side by side on blockIdx.y,
//     with kMatSmallGroup loads in flight: five times the threads for a
//     (10, 8) decode, each a fifth of the chain of dependent work.
//
// Registers (ptxas -v, sm_90a, scripts/by_value_variants.py, no spills):
// kernel 1 at 10 rows 128, kernel 2 at 7 rows 96 (__launch_bounds__ at 8
// and 10 blocks an SM), 60-77 for the 2- and 4-row shapes.  Rejected on
// an NVIDIA H100 80GB HBM3 at 700 W, kernel ms at B = 4096, C = 4 KB:
// all rows in one pass (12 or 16 rows, 122-158 registers: 0.24 / 0.35 ms
// for (10, 8) / (14, 10)); two vectors a thread (0.18-0.23 / 0.28-0.35
// at 168-255 registers); kernel 1 capped at 96 registers (0.151-0.158,
// with 17 spill stores); kernel 2 at 80 registers (0.261 against 0.279,
// with 4 spill stores).
//
// Bound: bytes, (k + m) * C per item: each input read once and each
// output written once (302 MB, 0.0901 ms at 3.35 TB/s for the (10, 8)
// decode at B = 4096, C = 4 KB).  The arithmetic is 2 __byte_perm and 3
// LOP3 per general coefficient and 4-byte word, plus about 15 operations
// per input word for its selectors: about 2e9 integer operations for that
// decode and 4e9 for the (14, 10) one (two passes), 0.12 and 0.25 ms of
// the CUDA cores' 64 integer operations a clock an SM at 1.98 GHz, so the
// larger matrices are held by integer issue, not by bytes.
// ---------------------------------------------------------------------------

constexpr int kNibWords = 6;
// Nib::l0 of g = 1 (g*i = i for i < 4): a plain XOR, no table
constexpr uint32_t kNibOne = 0x03020100u;
// the output rows a thread of kernel 1 (and 8) and of kernel 2 holds in
// registers when the card is full, and the blocks an SM must hold of each
// (__launch_bounds__, capping registers at 65,536 / (64 * blocks))
constexpr int kMat1Rows = 10;
constexpr int kMat1MinBlocks = 8;
constexpr int kMat2Rows = 7;
constexpr int kMat2MinBlocks = 10;
// a grid of fewer vectors than kFillThreads an SM splits the rows across
// threads instead (two rows a thread, a row group per blockIdx.y)
constexpr int kFillThreads = 512;
// input loads a thread of such a grid issues together
constexpr int kMatSmallGroup = 4;
// tier index of words in a device buffer (kernels 2 and 3)
constexpr int kDeviceTier = -1;

// words in the launch parameters, kCoefTiers bytes: kernel 1 and 2's
// nibble tables, kernel 3's row masks
template <int N>
struct CoefWords {
  uint32_t w[N / 4];
  __device__ __forceinline__ uint32_t word(int i) const { return w[i]; }
  __device__ __forceinline__ Nib nib(int i, uint32_t l0) const {
    Nib t;
    t.l0 = l0;
    t.l1 = w[i + 1];
    t.l8 = w[i + 2];
    t.h0 = w[i + 3];
    t.h1 = w[i + 4];
    t.h8 = w[i + 5];
    return t;
  }
};

// the same words in a device buffer, for matrices above the largest tier
struct DevWords {
  const uint32_t* __restrict__ w;
  __device__ __forceinline__ uint32_t word(int i) const { return __ldg(w + i); }
  __device__ __forceinline__ Nib nib(int i, uint32_t l0) const {
    Nib t;
    t.l0 = l0;
    t.l1 = __ldg(w + i + 1);
    t.l8 = __ldg(w + i + 2);
    t.h0 = __ldg(w + i + 3);
    t.h1 = __ldg(w + i + 4);
    t.h8 = __ldg(w + i + 5);
    return t;
  }
};

// out[b, r] = XOR_i A[r, i] * D[b, i], the tables of A[r, i] at words
// 6 * (r * k + i) of T.  Unit t is vector t % vecs of item t / vecs; a
// thread computes rows r0 .. r0 + MR - 1 for r0 = blockIdx.y * MR,
// stepping gridDim.y * MR (all rows when gridDim.y is 1), with G input
// loads in flight.  Every thread of a block runs the same number of
// turns of the unit loop (a thread past the last unit loads and stores
// nothing), so the matrix's indices, table loads and coefficient branches
// are uniform.
template <int MR, int G, class Tab>
__device__ __forceinline__ void shared_matmul(const Tab& T, int m, int k,
                                              const uint8_t* __restrict__ D,
                                              uint8_t* __restrict__ out, int B,
                                              long long C, long long vecs,
                                              bool vec) {
  const long long units = (long long)B * vecs;
  for (long long base = (long long)blockIdx.x * kSmallThreads; base < units;
       base += (long long)gridDim.x * kSmallThreads) {
    const long long t = base + threadIdx.x;
    const bool live = t < units;
    const long long b = live ? t / vecs : 0;
    const long long c0 = live ? (t - b * vecs) * kVec : 0;
    const int nb = live ? (int)min((long long)kVec, C - c0) : 0;
    const uint8_t* d = D + b * k * C + c0;
    uint8_t* o = out + b * m * C + c0;
    for (int r0 = blockIdx.y * MR; r0 < m; r0 += gridDim.y * MR) {
      V16 acc[MR];
#pragma unroll
      for (int r = 0; r < MR; ++r) acc[r] = zero16();
      for (int i0 = 0; i0 < k; i0 += G) {
        V16 x[G];
#pragma unroll
        for (int j = 0; j < G; ++j)
          x[j] = i0 + j < k && live
                     ? load16(d + (long long)(i0 + j) * C, nb, vec)
                     : zero16();
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (i0 + j >= k) break;
          const Sel4 s0 = nib_select(x[j].q.x), s1 = nib_select(x[j].q.y),
                     s2 = nib_select(x[j].q.z), s3 = nib_select(x[j].q.w);
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            if (r0 + r < m) {
              const int w = ((r0 + r) * k + i0 + j) * kNibWords;
              const uint32_t l0 = T.word(w);
              if (l0 == kNibOne) {
                xor16(acc[r], x[j]);
              } else if (l0 != 0u) {
                const Nib tb = T.nib(w, l0);
                acc[r].q.x ^= gf_mul4(s0, tb);
                acc[r].q.y ^= gf_mul4(s1, tb);
                acc[r].q.z ^= gf_mul4(s2, tb);
                acc[r].q.w ^= gf_mul4(s3, tb);
              }
            }
          }
        }
      }
      if (live) {
#pragma unroll
        for (int r = 0; r < MR; ++r)
          if (r0 + r < m) store16(o + (long long)(r0 + r) * C, acc[r], nb, vec);
      }
    }
  }
}

// kernel 1 (and 8): the unroll strategy's matrices, m * k <= kMaxCoefs
template <class Tab, int MR, int G>
__global__ void __launch_bounds__(kSmallThreads, kMat1MinBlocks)
matmul_batched_kernel(const __grid_constant__ Tab T, int m, int k,
                      const uint8_t* __restrict__ D, uint8_t* __restrict__ out,
                      int B, long long C, long long vecs, bool vec) {
  shared_matmul<MR, G>(T, m, k, D, out, B, C, vecs, vec);
}

// kernel 2: the cols strategy's larger dense matrices, m * k <=
// kColsMaxCoefs; the same body under its own name
template <class Tab, int MR, int G>
__global__ void __launch_bounds__(kSmallThreads, kMat2MinBlocks)
matmul_cols_kernel(const __grid_constant__ Tab T, int m, int k,
                   const uint8_t* __restrict__ D, uint8_t* __restrict__ out,
                   int B, long long C, long long vecs, bool vec) {
  shared_matmul<MR, G>(T, m, k, D, out, B, C, vecs, vec);
}

// ---------------------------------------------------------------------------
// The 0/1 product by value: kernel 3.
//
// Replaces gf256_matmul.py:_gf01_matmul_kernel: out[b, o] = XOR over the
// set bits j of row o of D[b, j], for a 0/1 (M, K) matrix that every item
// shares; D (B, K, C), out (B, M, C).  RDP(10,8)'s encode (32, 128) and
// every RDP decode run here, at C = 256 (a sub-block row) and B up to a
// YCSB window (64) on the main path, up to thousands in a recovery.  No
// multiply at all: 1*x is a select.  What shapes the design is how often
// each input is read and how uneven the rows are: the encode has 8-16 set
// bits a row (11.5 on average); the fused decode of two lost data chunks
// (160, 128) 10.9, its 32 rows of the lost chunks 8-72 and the other 128
// one each; the one-chunk decodes (128, 128) and (144, 128) 1-8
// (1.8-1.9).
//
//   * Row masks by value, built once per matrix.  The host packs each row
//     into ceil(K/32) 32-bit words (bit j % 32 of word j / 32;
//     gf256_matmul._plan, cached per matrix) and they travel in a
//     __grid_constant__ CoefWords struct of the kCoefTiers sizes: 512 B for
//     the encode, 2,048-2,560 B for the decodes.  Above the largest tier
//     (more than 8,160 words) they lie in a device buffer copied once per
//     matrix (DevWords), as kernel 2's tables.  The wrapper copies nothing
//     to the card and never waits on the stream.
//   * Two bodies, chosen on the host by the reads each makes.  The tile
//     body stages one item's (K, lanes*16) input tile in shared memory
//     (32 KB at (128, 256)) with cp.async, every load in flight at once
//     and no register spent on it, then its row groups of `lanes` threads
//     XOR their rows out of it: each input read once from device memory
//     however often the matrix uses it.  The direct body gives one thread
//     one 16-byte vector of one (item, row) pair and reads its set bits'
//     vectors straight from L1/L2: no staging, no __syncthreads, and a
//     sparse row reads only what it uses.  Per item vector the tile body
//     stages K vectors a row split, the direct body reads nnz (the
//     matrix's set bits), so the host takes the direct body when
//     100 * nnz < kGf01DirectPercent * K * splits: the one-chunk decodes
//     at small B, never the encode or a two-chunk decode.
//   * A grid that fills the card.  When B * tiles tile blocks are fewer
//     than kGf01FillBlocks an SM, the tile body splits its rows across
//     blockIdx.y (each split re-stages its tile, from L2); the direct
//     body is one thread a vector, 64-thread blocks.
//   * Uneven rows.  Split y takes rows y, y + splits, ..., so a band of
//     dense rows (a fused decode's rows of the lost chunks) spreads over
//     every split and a warp's two rows are neighbours of like weight;
//     each walk is an __ffs loop with kGroup loads in flight, its trip
//     count per thread, not unrolled.
//
// Registers (ptxas -v, sm_90a, scripts/by_value_variants.py, no spills):
// tile body 32, direct body 40.  Kernel ms on an NVIDIA H100 80GB HBM3 at
// 700 W, C = 256 (scripts/by_value_variants.py): the direct body
// everywhere read 0.285-0.301 / 0.0111 ms for the (160, 128) decode at
// B = 4096 / 64 against the tile body's 0.164 / 0.0078, and the tile body
// for the (128, 128) decode 0.0042-0.0048 ms at B = 36-64 against the
// direct body's 0.0031-0.0037.  Rejected: staging through registers, 8
// loads a thread (80 registers, 3 blocks an SM), 0.179-0.184 ms for the
// (160, 128) decode at B = 4096; mask words loaded four at a time a row
// ahead (48 registers) 0.194; 8 loads in flight in the walk (56
// registers) 0.208; kGf01FillBlocks 1 or 4 moved nothing at B <= 64.
//
// Bound: bytes, (K + M) * C per item: each input read once and each output
// written once; the XORs, nnz * C / 4 word operations an item, are far
// below the integer issue rate.  At B = 64 the (160, 128) decode's 1,744
// set bits read 28.6 MB of shared memory, about a microsecond of the
// card's shared-memory bandwidth, on top of the launch and the staging.
// ---------------------------------------------------------------------------

// the tile body splits its rows across blockIdx.y until its grid holds
// this many blocks an SM
constexpr int kGf01FillBlocks = 2;
// the host rule between the bodies (see above), in percent
constexpr int kGf01DirectPercent = 100;

// 16 bytes from device memory to shared memory without a register
// (cp.async, L2 only), and the wait for every such copy of the thread
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <class Tab>
__global__ void __launch_bounds__(kThreads)
gf01_tile_kernel(const __grid_constant__ Tab T, int M, int K, int words,
                 const uint8_t* __restrict__ D, uint8_t* __restrict__ out,
                 int B, long long C, int lane_bits, long long tiles,
                 bool vec) {
  extern __shared__ uint4 tile[];  // K rows of `lanes` 16-byte vectors
  const int lanes = 1 << lane_bits;
  const int per_block = kThreads >> lane_bits;
  const int sub = threadIdx.x >> lane_bits, lane = threadIdx.x & (lanes - 1);
  const int nvec = K << lane_bits;
  const long long units = (long long)B * tiles;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long b = u / tiles;
    const long long c_base = (u - b * tiles) * lanes * kVec;
    const uint8_t* d = D + b * K * C + c_base;
    __syncthreads();  // the previous unit's reads of the tile are done
    // every load of the tile in flight at once: asynchronous copies on the
    // 16-byte path, one vector at a time on the byte path
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const long long c = (long long)(v & (lanes - 1)) * kVec;
      const uint8_t* src = d + (long long)(v >> lane_bits) * C + c;
      if (c_base + c >= C)
        tile[v] = make_uint4(0u, 0u, 0u, 0u);
      else if (vec)
        copy16_async(tile + v, src);
      else
        tile[v] = load16(src, (int)min((long long)kVec, C - c_base - c),
                         false).q;
    }
    wait_async_copies();
    __syncthreads();
    const long long c0 = c_base + (long long)lane * kVec;
    if (c0 >= C) continue;
    const int nb = (int)min((long long)kVec, C - c0);
    // rows o = y + splits * (sub + per_block * i): neighbouring rows (a
    // band of dense ones, like the lost chunks' rows of a fused decode)
    // go to different splits
    for (int o = blockIdx.y + gridDim.y * sub; o < M;
         o += gridDim.y * per_block) {
      V16 acc = zero16();
      for (int w = 0; w < words; ++w) {
        uint32_t bits = T.word(o * words + w);
        const uint4* col = tile + ((w * 32) << lane_bits) + lane;
        while (bits) {
          V16 x[kGroup];
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            x[i] = zero16();
            if (bits) {
              x[i].q = col[(__ffs(bits) - 1) << lane_bits];
              bits &= bits - 1;
            }
          }
#pragma unroll
          for (int i = 0; i < kGroup; ++i) xor16(acc, x[i]);
        }
      }
      store16(out + (b * M + o) * C + c0, acc, nb, vec);
    }
  }
}

template <class Tab>
__global__ void __launch_bounds__(kSmallThreads)
gf01_direct_kernel(const __grid_constant__ Tab T, int M, int K, int words,
                   const uint8_t* __restrict__ D, uint8_t* __restrict__ out,
                   int B, long long C, long long vecs, bool vec) {
  const long long units = (long long)B * M * vecs;
  for (long long t = (long long)blockIdx.x * kSmallThreads + threadIdx.x;
       t < units; t += (long long)gridDim.x * kSmallThreads) {
    const long long pair = t / vecs;  // b * M + o
    const long long c0 = (t - pair * vecs) * kVec;
    const int nb = (int)min((long long)kVec, C - c0);
    const long long b = pair / M;
    const int o = (int)(pair - b * M);
    const uint8_t* d = D + b * K * C + c0;
    V16 acc = zero16();
    for (int w = 0; w < words; ++w) {
      uint32_t bits = T.word(o * words + w);
      const uint8_t* dw = d + (long long)w * 32 * C;
      while (bits) {
        V16 x[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          x[i] = zero16();
          if (bits) {
            x[i] = load16(dw + (long long)(__ffs(bits) - 1) * C, nb, vec);
            bits &= bits - 1;
          }
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) xor16(acc, x[i]);
      }
    }
    store16(out + pair * C + c0, acc, nb, vec);
  }
}

// Batched cuckoo-index probe: query q looks at its two buckets b1[q],
// b2[q] (4 slots each) and reports found[q] and slot[q], the least
// bucket*4 + slot whose fingerprint equals fp[q] and whose occupied byte
// is nonzero, or -1.  fps (B, 4) uint64, occ (B, 4) bytes.  Replaces
// kernels/cuckoo_lookup.py:_probe_kernel (the GET path's index probe,
// paper §3.2).
//
// The TPU kernel fetched the two (1, 4) bucket rows per grid step by
// scalar prefetch and compared fingerprints as (lo, hi) uint32 pairs, the
// TPU having no 64-bit lanes.  Here one thread serves one query with
// native 64-bit compares: it loads its bucket ids, reads each bucket's 32
// bytes of fingerprints as two 16-byte loads and its 4 occupancy bytes as
// one word, and writes 5 bytes.  Bound: the bytes the queries touch (two
// bucket rows, two ids, a fingerprint and two outputs per query), not the
// table: a probe gathers 36 scattered bytes per bucket row it reads, so
// its floor is memory latency at small Q and those bytes at large Q.
// b1 == b2 reads the same row twice and yields the same slot, as in the
// TPU kernel.  The bucket ids come from the host (h % B, as the reference
// computes them), so every row read is in the table.
__global__ void __launch_bounds__(kThreads)
cuckoo_probe_kernel(const unsigned long long* __restrict__ fps,
                    const uint8_t* __restrict__ occ,
                    const int32_t* __restrict__ b1,
                    const int32_t* __restrict__ b2,
                    const unsigned long long* __restrict__ fp,
                    uint8_t* __restrict__ found, int32_t* __restrict__ slot,
                    int Q, bool vec) {
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < Q;
       q += (long long)gridDim.x * blockDim.x) {
    const unsigned long long want = __ldg(fp + q);
    const int bucket[2] = {__ldg(b1 + q), __ldg(b2 + q)};
    int best = -1;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const long long b = bucket[p];
      unsigned long long f[4];
      uint32_t o;
      if (vec) {
        const ulonglong2* row = reinterpret_cast<const ulonglong2*>(fps + b * 4);
        const ulonglong2 lo = __ldg(row), hi = __ldg(row + 1);
        f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
        o = __ldg(reinterpret_cast<const uint32_t*>(occ + b * 4));
      } else {
        o = 0u;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          f[s] = __ldg(fps + b * 4 + s);
          o |= (uint32_t)__ldg(occ + b * 4 + s) << (8 * s);
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int cand = (int)(b * 4 + s);
        if (((o >> (8 * s)) & 0xffu) != 0u && f[s] == want &&
            (best < 0 || cand < best))
          best = cand;
      }
    }
    found[q] = best >= 0 ? 1 : 0;
    slot[q] = best;
  }
}

// the current device's SM count, queried once per device
int sm_count() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices] = {};
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess) return sms;
  if (dev >= 0 && dev < kMaxDevices) {
    const int c = cached[dev].load(std::memory_order_relaxed);
    if (c > 0) return c;
  }
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 132;
  if (dev >= 0 && dev < kMaxDevices)
    cached[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

int grid_for(long long units, int blocks_per_sm) {
  const long long cap = (long long)sm_count() * blocks_per_sm;
  return (int)(units < cap ? units : cap);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
}

// threads per row: a power of two, 16 bytes each, enough to cover C (at
// most a whole block)
int lanes_for(long long C) {
  const long long need = (C + kVec - 1) / kVec;
  int lanes = 1;
  while (lanes < kThreads && lanes < need) lanes <<= 1;
  return lanes;
}

long long tiles_for(long long C, int lanes) {
  const long long w = (long long)lanes * kVec;
  return (C + w - 1) / w;
}

int tier_bytes(int tier) {
  return tier >= 0 && tier < 3 ? kCoefTiers[tier] : -1;
}

// blocks for `threads` units of the by-value kernels: one unit a thread,
// at most kBlocksPerSm blocks an SM (the rest walk grid-stride)
int blocks_for(long long threads) {
  long long blocks = (threads + kSmallThreads - 1) / kSmallThreads;
  if (kBlocksPerSm > 0 && blocks > (long long)sm_count() * kBlocksPerSm)
    blocks = (long long)sm_count() * kBlocksPerSm;
  return blocks > INT_MAX ? -1 : (int)blocks;
}

template <int N>
int launch_per_item_tier(bool has_parity, const uint8_t* coefs,
                         long long nbytes, int mask_bytes, const uint8_t* P,
                         const uint8_t* D, uint8_t* out, int B, int O, int J,
                         long long C, cudaStream_t s) {
  CoefBytes<N> M;
  std::memcpy(M.b, coefs, (size_t)nbytes);
  const long long vecs = (C + kVec - 1) / kVec;
  const int grid = blocks_for((long long)B * O * vecs);
  if (grid < 0) return (int)cudaErrorInvalidValue;
  const bool vec = (C % kVec == 0) && aligned16(D) && aligned16(out) &&
                   (!has_parity || aligned16(P));
  if (has_parity && mask_bytes)
    per_item_kernel<true, true, N><<<grid, kSmallThreads, 0, s>>>(
        M, mask_bytes, P, D, out, B, O, J, C, vecs, vec);
  else if (has_parity)
    per_item_kernel<true, false, N><<<grid, kSmallThreads, 0, s>>>(
        M, 0, P, D, out, B, O, J, C, vecs, vec);
  else if (mask_bytes)
    per_item_kernel<false, true, N><<<grid, kSmallThreads, 0, s>>>(
        M, mask_bytes, nullptr, D, out, B, O, J, C, vecs, vec);
  else
    per_item_kernel<false, false, N><<<grid, kSmallThreads, 0, s>>>(
        M, 0, nullptr, D, out, B, O, J, C, vecs, vec);
  return (int)cudaGetLastError();
}

// One launch of kernel 4 (no parity) or 5 over B items whose coefficients
// (B*O*J bytes, or B*O*mask_bytes of row masks) lie on the host and fit
// parameter tier `tier`.
int launch_per_item(bool has_parity, int tier, const uint8_t* coefs,
                    int mask_bytes, const uint8_t* P, const uint8_t* D,
                    uint8_t* out, int B, int O, int J, long long C,
                    void* stream) {
  if (O <= 0 || J <= 0 || B <= 0 || C <= 0 || mask_bytes < 0 ||
      mask_bytes > 4 || (mask_bytes > 0 && J > 8 * mask_bytes))
    return (int)cudaErrorInvalidValue;
  const long long nbytes = (long long)B * O * (mask_bytes ? mask_bytes : J);
  if (nbytes > tier_bytes(tier)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case 0:
      return launch_per_item_tier<kCoefTiers[0]>(
          has_parity, coefs, nbytes, mask_bytes, P, D, out, B, O, J, C, s);
    case 1:
      return launch_per_item_tier<kCoefTiers[1]>(
          has_parity, coefs, nbytes, mask_bytes, P, D, out, B, O, J, C, s);
    default:
      return launch_per_item_tier<kCoefTiers[2]>(
          has_parity, coefs, nbytes, mask_bytes, P, D, out, B, O, J, C, s);
  }
}

template <int N>
int launch_delta_tier(bool has_parity, const uint8_t* G_host,
                      long long nbytes, const uint8_t* P, const uint8_t* X,
                      uint8_t* out, int B, int m, long long C,
                      cudaStream_t s) {
  CoefBytes<N> G;
  std::memcpy(G.b, G_host, (size_t)nbytes);
  const long long vecs = (C + kVec - 1) / kVec;
  const int grid = blocks_for((long long)B * vecs);
  if (grid < 0) return (int)cudaErrorInvalidValue;
  const bool vec = (C % kVec == 0) && aligned16(X) && aligned16(out) &&
                   (!has_parity || aligned16(P));
  if (has_parity)
    delta_batched_kernel<true, N><<<grid, kSmallThreads, 0, s>>>(
        G, P, X, out, B, m, C, vecs, vec);
  else
    delta_batched_kernel<false, N><<<grid, kSmallThreads, 0, s>>>(
        G, nullptr, X, out, B, m, C, vecs, vec);
  return (int)cudaGetLastError();
}

// One launch of kernel 6 (with parity) or 7 over B items whose (B, m)
// gammas lie on the host as bytes and fit parameter tier `tier`.
int launch_delta(bool has_parity, int tier, const uint8_t* G_host,
                 const uint8_t* P, const uint8_t* X, uint8_t* out, int B,
                 int m, long long C, void* stream) {
  if (m <= 0 || B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long nbytes = (long long)B * m;
  if (nbytes > tier_bytes(tier)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case 0:
      return launch_delta_tier<kCoefTiers[0]>(has_parity, G_host, nbytes, P,
                                              X, out, B, m, C, s);
    case 1:
      return launch_delta_tier<kCoefTiers[1]>(has_parity, G_host, nbytes, P,
                                              X, out, B, m, C, s);
    default:
      return launch_delta_tier<kCoefTiers[2]>(has_parity, G_host, nbytes, P,
                                              X, out, B, m, C, s);
  }
}

template <bool COLS, class Tab, int MR, int G>
int launch_shape(const Tab& T, int m, int k, const uint8_t* D, uint8_t* out,
                 int B, long long C, long long vecs, bool vec, int groups,
                 cudaStream_t s) {
  const int bx = blocks_for((long long)B * vecs);
  if (bx < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(bx, groups);
  if constexpr (COLS)
    matmul_cols_kernel<Tab, MR, G><<<grid, kSmallThreads, 0, s>>>(
        T, m, k, D, out, B, C, vecs, vec);
  else
    matmul_batched_kernel<Tab, MR, G><<<grid, kSmallThreads, 0, s>>>(
        T, m, k, D, out, B, C, vecs, vec);
  return (int)cudaGetLastError();
}

// The shape of kernel 1 or 2 for m rows over B * vecs vectors: when the
// vectors fill the card (kFillThreads an SM), a thread takes every row in
// passes of 2, 4 (m <= 2, m <= 4), kMat1Rows or kMat2Rows rows; otherwise
// it takes two rows, the row groups side by side on blockIdx.y (at most
// 16,384 of them, within the 65,535 a grid allows), so a B = 64 decode
// runs five times the threads with a fifth of the work each.  The 2- and
// 4-row shapes keep a small matrix off the 10-row body's 128 registers:
// without them a (2, 8) / (4, 10) encode at B = 4096, C = 4 KB took
// 0.1256 / 0.1934 ms against 0.0767 / 0.1348 (scripts/kernel_ab.py,
// NVIDIA H100 80GB HBM3 at 700 W).
template <bool COLS, class Tab>
int launch_shared(const Tab& T, int m, int k, const uint8_t* D, uint8_t* out,
                  int B, long long C, cudaStream_t s) {
  const long long vecs = (C + kVec - 1) / kVec;
  const bool vec = (C % kVec == 0) && aligned16(D) && aligned16(out);
  const bool fills =
      (long long)B * vecs >= (long long)sm_count() * kFillThreads;
  if (!fills)
    return launch_shape<COLS, Tab, 2, kMatSmallGroup>(
        T, m, k, D, out, B, C, vecs, vec, (m + 1) / 2, s);
  if (m <= 2)
    return launch_shape<COLS, Tab, 2, kGroup>(T, m, k, D, out, B, C, vecs, vec,
                                              1, s);
  if (m <= 4)
    return launch_shape<COLS, Tab, 4, kGroup>(T, m, k, D, out, B, C, vecs, vec,
                                              1, s);
  if constexpr (COLS)
    return launch_shape<COLS, Tab, kMat2Rows, kGroup>(T, m, k, D, out, B, C,
                                                      vecs, vec, 1, s);
  else
    return launch_shape<COLS, Tab, kMat1Rows, kGroup>(T, m, k, D, out, B, C,
                                                      vecs, vec, 1, s);
}

template <bool COLS, int N>
int launch_shared_tier(const uint8_t* tabs, long long nbytes, int m, int k,
                       const uint8_t* D, uint8_t* out, int B, long long C,
                       cudaStream_t s) {
  CoefWords<N> T;
  std::memcpy(T.w, tabs, (size_t)nbytes);
  return launch_shared<COLS>(T, m, k, D, out, B, C, s);
}

// One launch of kernel 1 (COLS = false) or 2 over B items sharing the
// (m, k) matrix whose tables (m*k*24 bytes, coefs.matrix_tables) lie on
// the host and fit parameter tier `tier`, or, for kernel 2 with tier
// kDeviceTier, lie on the card at `tabs`.
template <bool COLS>
int launch_shared_matmul(int tier, const uint8_t* tabs, int m, int k,
                         const uint8_t* D, uint8_t* out, int B, long long C,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tier == kDeviceTier) {
    if constexpr (COLS)
      return launch_shared<COLS>(
          DevWords{reinterpret_cast<const uint32_t*>(tabs)}, m, k, D, out, B,
          C, s);
    return (int)cudaErrorInvalidValue;
  }
  const long long nbytes = (long long)m * k * kNibWords * 4;
  if (nbytes > tier_bytes(tier)) return (int)cudaErrorInvalidValue;
  switch (tier) {
    case 0:
      return launch_shared_tier<COLS, kCoefTiers[0]>(tabs, nbytes, m, k, D,
                                                     out, B, C, s);
    case 1:
      return launch_shared_tier<COLS, kCoefTiers[1]>(tabs, nbytes, m, k, D,
                                                     out, B, C, s);
    default:
      return launch_shared_tier<COLS, kCoefTiers[2]>(tabs, nbytes, m, k, D,
                                                     out, B, C, s);
  }
}

// tile bodies may take more than the default 48 KB of shared memory;
// the attribute is set once per device and instantiation, not per call
template <class Tab>
cudaError_t allow_gf01_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev >= 0 && dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(gf01_tile_kernel<Tab>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kGf01Smem);
  if (e == cudaSuccess && bit) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// One launch of kernel 3 on masks T: the tile body, its rows split across
// blockIdx.y while the grid is short of kGf01FillBlocks an SM, or the
// direct body where it reads less (see the note above).
template <class Tab>
int launch_gf01(const Tab& T, int M, int K, long long nnz, const uint8_t* D,
                uint8_t* out, int B, long long C, cudaStream_t s) {
  const int words = (K + 31) / 32;
  const bool vec = (C % kVec == 0) && aligned16(D) && aligned16(out);
  int lanes = lanes_for(C);
  while (lanes > 1 && (long long)K * lanes * kVec > kGf01Smem) lanes >>= 1;
  const long long tiles = tiles_for(C, lanes);
  const long long units = (long long)B * tiles;
  const long long per_block = kThreads / lanes;
  const long long most = (M + per_block - 1) / per_block;
  const long long fill = (long long)sm_count() * kGf01FillBlocks;
  long long splits = units >= fill ? 1 : (fill + units - 1) / units;
  if (splits > most) splits = most;
  if (100 * nnz < (long long)kGf01DirectPercent * K * splits) {
    const long long vecs = (C + kVec - 1) / kVec;
    const int grid = blocks_for((long long)B * M * vecs);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    gf01_direct_kernel<Tab><<<grid, kSmallThreads, 0, s>>>(
        T, M, K, words, D, out, B, C, vecs, vec);
    return (int)cudaGetLastError();
  }
  const int smem = K * lanes * kVec;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_gf01_smem<Tab>();
    if (e != cudaSuccess) return (int)e;
  }
  int lane_bits = 0;
  while ((1 << lane_bits) < lanes) ++lane_bits;
  const int per_sm = (200 * 1024) / smem;
  const dim3 grid(grid_for(units, per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm)),
                  (unsigned)splits);
  gf01_tile_kernel<Tab><<<grid, kThreads, smem, s>>>(
      T, M, K, words, D, out, B, C, lane_bits, tiles, vec);
  return (int)cudaGetLastError();
}

template <int N>
int launch_gf01_tier(const uint8_t* masks, long long nbytes, int M, int K,
                     long long nnz, const uint8_t* D, uint8_t* out, int B,
                     long long C, cudaStream_t s) {
  CoefWords<N> T;
  std::memcpy(T.w, masks, (size_t)nbytes);
  return launch_gf01(T, M, K, nnz, D, out, B, C, s);
}

}  // namespace

extern "C" {

const char* gf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gf_max_coefs() { return kMaxCoefs; }

// Kernel 1: `tier` indexes the parameter-struct sizes (gf_coef_tier) that
// hold the matrix's host-built tables `tabs` (coefs.matrix_tables).
int gf_matmul_batched(int tier, const uint8_t* tabs, int m, int k,
                      const uint8_t* D, uint8_t* out, int B, long long C,
                      void* stream) {
  if (m <= 0 || k <= 0 || m * k > kMaxCoefs || B <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_shared_matmul<false>(tier, tabs, m, k, D, out, B, C, stream);
}

int gf_cols_max_coefs() { return kColsMaxCoefs; }

int gf01_max_cols() { return kGf01MaxCols; }

// Kernel 2: as kernel 1, and tier kDeviceTier (-1) takes `tabs` as a
// device pointer, for tables above the largest tier.
int gf_matmul_cols_batched(int tier, const uint8_t* tabs, int m, int k,
                           const uint8_t* D, uint8_t* out, int B, long long C,
                           void* stream) {
  if (m <= 0 || k <= 0 || (long long)m * k > kColsMaxCoefs || B <= 0 ||
      C <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_shared_matmul<true>(tier, tabs, m, k, D, out, B, C, stream);
}

// Kernel 3: `tier` indexes the parameter-struct sizes that hold the
// matrix's host-built row masks `masks` (M * ceil(K/32) words), or with
// tier kDeviceTier they lie on the card at `masks`; `nnz` is the
// matrix's count of set bits.
int gf01_matmul_batched(int tier, const uint8_t* masks, int M, int K,
                        long long nnz, const uint8_t* D, uint8_t* out, int B,
                        long long C, void* stream) {
  if (M <= 0 || K <= 0 || K > kGf01MaxCols || B <= 0 || C <= 0 || nnz < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tier == kDeviceTier)
    return launch_gf01(DevWords{reinterpret_cast<const uint32_t*>(masks)}, M,
                       K, nnz, D, out, B, C, s);
  const long long nbytes = (long long)M * ((K + 31) / 32) * 4;
  if (nbytes > tier_bytes(tier)) return (int)cudaErrorInvalidValue;
  switch (tier) {
    case 0:
      return launch_gf01_tier<kCoefTiers[0]>(masks, nbytes, M, K, nnz, D, out,
                                             B, C, s);
    case 1:
      return launch_gf01_tier<kCoefTiers[1]>(masks, nbytes, M, K, nnz, D, out,
                                             B, C, s);
    default:
      return launch_gf01_tier<kCoefTiers[2]>(masks, nbytes, M, K, nnz, D, out,
                                             B, C, s);
  }
}

// Kernels 4-7: `tier` indexes the parameter-struct sizes (gf_coef_tier);
// the coefficients are host memory, copied into the launch parameters.
int gf_coef_tier(int tier) { return tier_bytes(tier); }

int gf_per_item_fold(int tier, const uint8_t* coefs, int mask_bytes,
                     const uint8_t* P, const uint8_t* D, uint8_t* out, int B,
                     int O, int J, long long C, void* stream) {
  return launch_per_item(true, tier, coefs, mask_bytes, P, D, out, B, O, J,
                         C, stream);
}

int gf_per_item(int tier, const uint8_t* coefs, int mask_bytes,
                const uint8_t* D, uint8_t* out, int B, int O, int J,
                long long C, void* stream) {
  return launch_per_item(false, tier, coefs, mask_bytes, nullptr, D, out, B,
                         O, J, C, stream);
}

int gf_delta_apply_batched(int tier, const uint8_t* G, const uint8_t* P,
                           const uint8_t* X, uint8_t* out, int B, int m,
                           long long C, void* stream) {
  return launch_delta(true, tier, G, P, X, out, B, m, C, stream);
}

int gf_delta_only_batched(int tier, const uint8_t* G, const uint8_t* X,
                          uint8_t* out, int B, int m, long long C,
                          void* stream) {
  return launch_delta(false, tier, G, nullptr, X, out, B, m, C, stream);
}

// Single-stripe A (*) D, D (k, C) -> out (m, C): kernel 1 with B = 1.
// Replaces gf256_matmul.py:_gf_matmul_kernel (kernels/ops.py
// encode_stripe/decode_stripe).  The TPU needed a rank-2 kernel only
// because a BlockSpec fixes the rank; the body is the same.  One thread a
// 16-byte vector, so one 4 KB chunk is four 64-thread blocks and a 1 MiB
// stripe 1,024 (a launch-bound call either way).  Matrices above the
// unroll rule go to the column-loop or 0/1 kernels with B = 1 (the Python
// wrapper decides).
int gf_matmul(int tier, const uint8_t* tabs, int m, int k, const uint8_t* D,
              uint8_t* out, long long C, void* stream) {
  return gf_matmul_batched(tier, tabs, m, k, D, out, 1, C, stream);
}

int gf_delta_max_rows() { return kDeltaMaxRows; }

// Kernel 9: the m gamma bytes lie on the host.
int gf_delta_update(const uint8_t* G_host, int m, const uint8_t* P,
                    const uint8_t* old, const uint8_t* nw, uint8_t* out,
                    long long C, void* stream) {
  if (m <= 0 || m > kDeltaMaxRows || C <= 0) return (int)cudaErrorInvalidValue;
  CoefBytes<kCoefTiers[0]> G;
  std::memcpy(G.b, G_host, (size_t)m);
  const long long vecs = (C + kVec - 1) / kVec;
  const int grid = blocks_for(vecs);
  if (grid < 0) return (int)cudaErrorInvalidValue;
  const bool vec = (C % kVec == 0) && aligned16(P) && aligned16(old) &&
                   aligned16(nw) && aligned16(out);
  delta_update_kernel<<<grid, kSmallThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      G, P, old, nw, out, m, C, vecs, vec);
  return (int)cudaGetLastError();
}

int gf_cuckoo_probe(const unsigned long long* fps, const uint8_t* occ,
                    const int32_t* b1, const int32_t* b2,
                    const unsigned long long* fp, uint8_t* found,
                    int32_t* slot, int Q, void* stream) {
  if (Q <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(fps) && aligned4(occ);
  const int grid = grid_for(((long long)Q + kThreads - 1) / kThreads, 8);
  cuckoo_probe_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fps, occ, b1, b2, fp, found, slot, Q, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
