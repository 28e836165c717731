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
// TPU's vector unit cannot gather bytes.  A GPU gathers from shared memory
// cheaply, so here a GF(2^8) product is a table lookup:
//
//   * gf_matmul_batched keeps one 256-byte MUL_TABLE row per coefficient
//     of the shared (m, k) matrix in shared memory (m*k*256 bytes, 20 KB
//     at (10, 8)): one lookup per product;
//   * the column-loop kernel and the single-stripe delta keep the 512-byte
//     EXP and 256-byte LOG tables in shared memory: g*x = x ? EXP[LOG[x] +
//     LOG[g]] : 0.  The column-loop kernel takes LOG[x] once per input
//     byte and shares it across a group of 4 output rows held in
//     registers;
//   * the per-item and batched delta kernels (4-7) build two 16-entry
//     nibble tables of their coefficient in registers and look bytes up
//     four at a time with __byte_perm (see "Coefficients by value" below);
//   * a 0/1 coefficient needs no table at all: 1*x is a select, so
//     gf01_matmul_batched is pure XOR over the set bits of each matrix
//     row (packed into 32-bit masks and walked with __ffs), and the
//     per-item kernels walk 0/1 rows the same way (the RDP deltas and
//     seal folds are 0/1) and XOR whole 16-byte vectors when g = 1.
//
// Work split of kernels 1-3: a block is 256 threads and each thread owns
// 16 contiguous bytes of a row.  RDP's sub-block rows are 256 bytes (C/r
// at 4 KB chunks, r = 16), so a kernel that gave a block one 4096-byte
// tile of one row would idle 15 of every 16 threads.  Instead the host
// picks `lanes`, the
// threads per row (a power of two, 16 bytes each, just enough to cover C
// up to 256 threads), and a block covers 256 / lanes rows side by side:
//
//   * the column-loop kernel puts 256 / lanes items in one block;
//   * the 0/1 kernel stages one item's (K, lanes*16) input tile in shared
//     memory (32 KB at RDP's (128, 256)), reading each input byte once,
//     and the block's 256 / lanes row groups XOR output rows out of it.
//
// Blocks walk their units grid-stride, so the tables are built once per
// block.  When C is a multiple of 16 and every pointer is 16-byte aligned
// the bytes move as one 16-byte vector load/store per thread; otherwise
// (C = 1000, say) the same loop runs a byte at a time and masks the
// ragged tail.
//
// Bound: each kernel moves every input byte once and every output byte
// once; at the shapes of the coding path that is far below the card's
// compute, so the floor is device-memory bandwidth.  The tables stay on
// chip (no global gathers) and each output byte is written once.
// Shared-memory byte gathers with bank conflicts are the expected limit of
// the table kernels; the 0/1 kernel's inner loop is one conflict-free
// 16-byte shared-memory load and XOR per set bit.
//
// The single-stripe entries of kernels/ops.py and the index probe have
// notes of their own beside their kernels below.
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
constexpr int kTile = kThreads * kVec;
// shared (m, k) matrix: its coefficients travel in the kernel parameters,
// and its MUL_TABLE rows (m*k*256 bytes) must fit in shared memory
constexpr int kMaxCoefs = 896;
// column-loop kernel: the (m, k) matrix is staged in shared memory
constexpr int kColsMaxCoefs = 32768;
// output rows a column-loop thread accumulates in registers at once
constexpr int kColsRows = 4;
// 0/1 kernel: shared memory for one (K, lanes*16) input tile; at one
// lane a row takes 16 bytes, so K may reach kGf01Smem / 16 columns
constexpr int kGf01Smem = 96 * 1024;
constexpr int kGf01MaxCols = kGf01Smem / kVec;
// single-stripe delta: the m gammas travel in the kernel parameters
constexpr int kDeltaMaxRows = 256;

// Layout of the device table buffer the wrapper passes in:
// MUL_TABLE (256*256) | EXP_TABLE (512) | LOG_TABLE as bytes (256).
constexpr int kMulOff = 0;
constexpr int kExpOff = 65536;
constexpr int kLogOff = 65536 + 512;

struct Coefs {
  uint8_t a[kMaxCoefs];
};

struct Gammas {
  uint8_t g[kDeltaMaxRows];
};

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

__device__ __forceinline__ void load_exp_log(const uint8_t* __restrict__ tables,
                                             uint8_t* exp_s, uint8_t* log_s) {
  for (int i = threadIdx.x; i < 512; i += blockDim.x)
    exp_s[i] = tables[kExpOff + i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    log_s[i] = tables[kLogOff + i];
  __syncthreads();
}

// P[b, r] = XOR_i A[r, i] * D[b, i]  over GF(2^8); D (B, k, C), P (B, m, C).
__global__ void __launch_bounds__(kThreads)
matmul_batched_kernel(Coefs A, int m, int k, const uint8_t* __restrict__ tables,
                      const uint8_t* __restrict__ D, uint8_t* __restrict__ out,
                      int B, long long C, long long tiles, bool vec) {
  extern __shared__ uint8_t tab[];  // m*k rows of 256 products
  const int nt = m * k * 256;
  for (int i = threadIdx.x; i < nt; i += blockDim.x)
    tab[i] = tables[kMulOff + (int)A.a[i >> 8] * 256 + (i & 255)];
  __syncthreads();
  const long long units = (long long)B * tiles;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long b = u / tiles;
    const long long c0 = (u % tiles) * kTile + (long long)threadIdx.x * kVec;
    if (c0 >= C) continue;
    const int nb = (int)min((long long)kVec, C - c0);
    const uint8_t* d = D + b * k * C + c0;
    uint8_t* o = out + b * m * C + c0;
    for (int r = 0; r < m; ++r) {
      V16 acc;
      acc.q = make_uint4(0u, 0u, 0u, 0u);
      for (int i = 0; i < k; ++i) {
        const V16 x = load16(d + (long long)i * C, nb, vec);
        const uint8_t* row = tab + (r * k + i) * 256;
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc.b[j] ^= row[x.b[j]];
      }
      store16(o + (long long)r * C, acc, nb, vec);
    }
  }
}

// out[b, o] = XOR_i A[o, i] * D[b, i] for a dense (m, k) matrix above the
// unroll limit; A (m, k) uint8 in device memory, D (B, k, C), out (B, m, C).
// A block holds 256 / lanes items side by side, each thread 16 bytes of
// one item; output rows go in groups of kColsRows, accumulated in
// registers, so each input vector and its LOG bytes are loaded once per
// group and shared by the group's rows (once in all for m <= 4, four
// times at RS(14,10)'s (14, 10)).  Groups of 4 keep the thread at 64
// registers with no spills; groups of 8 or 16 spilled to local memory.
__global__ void __launch_bounds__(kThreads)
matmul_cols_kernel(const uint8_t* __restrict__ tables,
                   const uint8_t* __restrict__ A, int m, int k,
                   const uint8_t* __restrict__ D, uint8_t* __restrict__ out,
                   int B, long long C, int lanes, long long tiles, bool vec) {
  __shared__ uint8_t exp_s[512];
  __shared__ uint8_t log_s[256];
  extern __shared__ uint8_t a_s[];  // the m*k coefficients
  for (int i = threadIdx.x; i < m * k; i += blockDim.x) a_s[i] = A[i];
  load_exp_log(tables, exp_s, log_s);
  const int per_block = blockDim.x / lanes;
  const int sub = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const long long groups = ((long long)B + per_block - 1) / per_block;
  const long long units = groups * tiles;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long b = (u / tiles) * per_block + sub;
    const long long c0 = (u % tiles) * lanes * kVec + (long long)lane * kVec;
    if (b >= B || c0 >= C) continue;
    const int nb = (int)min((long long)kVec, C - c0);
    const uint8_t* d = D + b * k * C + c0;
    uint8_t* o = out + b * m * C + c0;
    for (int r0 = 0; r0 < m; r0 += kColsRows) {
      // acc[r][w]: bytes 4w..4w+3 of output row r0 + r, built with
      // shifts so the accumulators stay in registers
      uint32_t acc[kColsRows][4];
#pragma unroll
      for (int r = 0; r < kColsRows; ++r)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[r][w] = 0u;
      for (int i = 0; i < k; ++i) {
        const V16 x = load16(d + (long long)i * C, nb, vec);
        // LOG of each byte, 255 (no log is that large) marking a zero byte
        V16 lx;
#pragma unroll
        for (int t = 0; t < kVec; ++t) lx.b[t] = x.b[t] ? log_s[x.b[t]] : 255;
#pragma unroll
        for (int r = 0; r < kColsRows; ++r) {
          const int g = r0 + r < m ? a_s[(r0 + r) * k + i] : 0;
          if (g == 0) continue;
          const int lg = log_s[g];
#pragma unroll
          for (int t = 0; t < kVec; ++t) {
            const int l = lx.b[t];
            const uint32_t p = l == 255 ? 0u : exp_s[l + lg];
            acc[r][t >> 2] ^= p << (8 * (t & 3));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kColsRows; ++r) {
        if (r0 + r < m) {
          V16 v;
          v.q = make_uint4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          store16(o + (long long)(r0 + r) * C, v, nb, vec);
        }
      }
    }
  }
}

// out[b, o] = XOR_{j : bit j of row o} D[b, j] for a 0/1 (M, K) matrix;
// masks (M, words) uint32 in device memory, bit j % 32 of word j / 32.
// One unit is (item, column tile of lanes*16 bytes): the block stages the
// item's (K, lanes*16) input tile in shared memory once, then its
// 256 / lanes row groups each XOR every (256 / lanes)-th output row out of
// it, one 16-byte vector per thread per set bit.
__global__ void __launch_bounds__(kThreads)
gf01_matmul_kernel(const uint32_t* __restrict__ masks, int M, int K,
                   int words, const uint8_t* __restrict__ D,
                   uint8_t* __restrict__ out, int B, long long C, int lanes,
                   long long tiles, bool vec) {
  extern __shared__ uint4 tile[];  // K rows of `lanes` 16-byte vectors
  const int per_block = blockDim.x / lanes;
  const int sub = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const long long units = (long long)B * tiles;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long b = u / tiles;
    const long long c_base = (u % tiles) * lanes * kVec;
    __syncthreads();  // the previous unit's reads of the tile are done
    for (int v = threadIdx.x; v < K * lanes; v += blockDim.x) {
      const int j = v / lanes;
      const long long c0 = c_base + (long long)(v % lanes) * kVec;
      V16 x;
      if (c0 < C)
        x = load16(D + (b * K + j) * C + c0, (int)min((long long)kVec, C - c0),
                   vec);
      else
        x.q = make_uint4(0u, 0u, 0u, 0u);
      tile[v] = x.q;
    }
    __syncthreads();
    const long long c0 = c_base + (long long)lane * kVec;
    if (c0 >= C) continue;
    const int nb = (int)min((long long)kVec, C - c0);
    for (int o = sub; o < M; o += per_block) {
      V16 acc;
      acc.q = make_uint4(0u, 0u, 0u, 0u);
      const uint32_t* row = masks + (long long)o * words;
      for (int w = 0; w < words; ++w) {
        uint32_t bits = __ldg(row + w);
        while (bits) {
          const int j = w * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
          V16 x;
          x.q = tile[j * lanes + lane];
          xor16(acc, x);
        }
      }
      store16(out + (b * M + o) * C + c0, acc, nb, vec);
    }
  }
}

// ---------------------------------------------------------------------------
// Coefficients by value: the per-item kernels (4, 5) and the batched delta
// kernels (6, 7).
//
// Replace gf256_matmul.py:_per_item_kernel / _per_item_fold_kernel and
// delta_update.py:_delta_apply_batched_kernel / _delta_only_batched_kernel.
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
// per-item fold (2O + J)*C, without parity (O + J)*C.
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
// out (B, m, C).  HAS_PARITY = false is the delta-only body (kernel 7).
// Unit t is vector t % vecs of item t / vecs, for all m rows.
template <bool HAS_PARITY, int N>
__global__ void __launch_bounds__(kSmallThreads)
delta_batched_kernel(const __grid_constant__ CoefBytes<N> G,
                     const uint8_t* __restrict__ P,
                     const uint8_t* __restrict__ X, uint8_t* __restrict__ out,
                     int B, int m, long long C, long long vecs, bool vec) {
  const long long units = (long long)B * vecs;
  for (long long t = (long long)blockIdx.x * kSmallThreads + threadIdx.x;
       t < units; t += (long long)gridDim.x * kSmallThreads) {
    const long long b = t / vecs;
    const long long c0 = (t - b * vecs) * kVec;
    const int nb = (int)min((long long)kVec, C - c0);
    const V16 x = load16(X + b * C + c0, nb, vec);
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

// Single-stripe fused delta  out[r] = P[r] ^ g[r] * (old ^ new); P and
// out (m, C), old and new (C,).  Replaces delta_update.py:_delta_kernel,
// the UPDATE path of kernels/ops.py:apply_parity_delta.
//
// Bound: device-memory bytes, (2m + 2) * C: parity, old and new are each
// read once and parity written once.  The xor of old and new is formed in
// registers, never stored; a torch `old ^ new` followed by the batched
// delta kernel would move 3 * C bytes more.  The m gammas (m <= 14 for
// every code here) travel by value in the kernel parameters, so the
// wrapper copies nothing to the card before the launch.  Each thread owns
// 16 bytes of the row: it takes LOG of the xor once and spends one EXP
// lookup per output byte; blocks walk 4096-byte tiles grid-stride.
__global__ void __launch_bounds__(kThreads)
delta_update_kernel(const uint8_t* __restrict__ tables, Gammas G, int m,
                    const uint8_t* __restrict__ P,
                    const uint8_t* __restrict__ old,
                    const uint8_t* __restrict__ nw, uint8_t* __restrict__ out,
                    long long C, long long tiles, bool vec) {
  __shared__ uint8_t exp_s[512];
  __shared__ uint8_t log_s[256];
  load_exp_log(tables, exp_s, log_s);
  for (long long u = blockIdx.x; u < tiles; u += gridDim.x) {
    const long long c0 = u * kTile + (long long)threadIdx.x * kVec;
    if (c0 >= C) continue;
    const int nb = (int)min((long long)kVec, C - c0);
    V16 x = load16(old + c0, nb, vec);
    xor16(x, load16(nw + c0, nb, vec));
    V16 lx;
#pragma unroll
    for (int t = 0; t < kVec; ++t) lx.b[t] = log_s[x.b[t]];
    for (int r = 0; r < m; ++r) {
      V16 acc = load16(P + (long long)r * C + c0, nb, vec);
      const int g = G.g[r];
      if (g != 0) {
        const int lg = log_s[g];
#pragma unroll
        for (int t = 0; t < kVec; ++t)
          acc.b[t] ^= x.b[t] ? exp_s[lx.b[t] + lg] : (uint8_t)0;
      }
      store16(out + (long long)r * C + c0, acc, nb, vec);
    }
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

}  // namespace

extern "C" {

const char* gf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gf_max_coefs() { return kMaxCoefs; }

int gf_matmul_batched(const uint8_t* A_host, int m, int k,
                      const uint8_t* tables, const uint8_t* D, uint8_t* out,
                      int B, long long C, void* stream) {
  if (m * k > kMaxCoefs || m <= 0 || k <= 0 || B <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  Coefs A;
  for (int i = 0; i < m * k; ++i) A.a[i] = A_host[i];
  const int smem = m * k * 256;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        matmul_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (C + kTile - 1) / kTile;
  const bool vec = (C % kVec == 0) && aligned16(D) && aligned16(out);
  const int blocks_per_sm = smem > 0 ? (int)(200 * 1024 / smem) : 8;
  const int grid = grid_for((long long)B * tiles,
                            blocks_per_sm < 1 ? 1 : (blocks_per_sm > 8 ? 8 : blocks_per_sm));
  matmul_batched_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      A, m, k, tables, D, out, B, C, tiles, vec);
  return (int)cudaGetLastError();
}

int gf_cols_max_coefs() { return kColsMaxCoefs; }

int gf01_max_cols() { return kGf01MaxCols; }

int gf_matmul_cols_batched(const uint8_t* tables, const uint8_t* A, int m,
                           int k, const uint8_t* D, uint8_t* out, int B,
                           long long C, void* stream) {
  if (m <= 0 || k <= 0 || m * k > kColsMaxCoefs || B <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  const int lanes = lanes_for(C);
  const long long tiles = tiles_for(C, lanes);
  const bool vec = (C % kVec == 0) && aligned16(D) && aligned16(out);
  const int per_block = kThreads / lanes;
  const int grid = grid_for(((long long)B + per_block - 1) / per_block * tiles, 8);
  matmul_cols_kernel<<<grid, kThreads, m * k,
                       static_cast<cudaStream_t>(stream)>>>(
      tables, A, m, k, D, out, B, C, lanes, tiles, vec);
  return (int)cudaGetLastError();
}

int gf01_matmul_batched(const uint32_t* masks, int M, int K, const uint8_t* D,
                        uint8_t* out, int B, long long C, void* stream) {
  if (M <= 0 || K <= 0 || K > kGf01MaxCols || B <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  int lanes = lanes_for(C);
  while (lanes > 1 && (long long)K * lanes * kVec > kGf01Smem) lanes >>= 1;
  const int smem = K * lanes * kVec;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf01_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kGf01Smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = tiles_for(C, lanes);
  const bool vec = (C % kVec == 0) && aligned16(D) && aligned16(out);
  const int per_sm = (200 * 1024) / smem;
  const int grid = grid_for((long long)B * tiles,
                            per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm));
  gf01_matmul_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      masks, M, K, (K + 31) / 32, D, out, B, C, lanes, tiles, vec);
  return (int)cudaGetLastError();
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

// Single-stripe A (*) D, D (k, C) -> out (m, C): the table kernel of
// gf_matmul_batched with B = 1.  Replaces gf256_matmul.py:_gf_matmul_kernel
// (kernels/ops.py encode_stripe/decode_stripe).  The TPU needed a rank-2
// kernel only because a BlockSpec fixes the rank; the body is the same
// one-lookup-per-product loop.  It walks ceil(C / 4096) tiles grid-stride,
// so a wide stripe spreads over the SMs while one 4 KB chunk is one block
// (a launch-bound call either way).  Matrices above the unroll rule go to
// the column-loop or 0/1 kernels with B = 1 (the Python wrapper decides).
int gf_matmul(const uint8_t* A_host, int m, int k, const uint8_t* tables,
              const uint8_t* D, uint8_t* out, long long C, void* stream) {
  return gf_matmul_batched(A_host, m, k, tables, D, out, 1, C, stream);
}

int gf_delta_max_rows() { return kDeltaMaxRows; }

int gf_delta_update(const uint8_t* tables, const int32_t* G_host, int m,
                    const uint8_t* P, const uint8_t* old, const uint8_t* nw,
                    uint8_t* out, long long C, void* stream) {
  if (m <= 0 || m > kDeltaMaxRows || C <= 0) return (int)cudaErrorInvalidValue;
  Gammas G;
  for (int r = 0; r < m; ++r) G.g[r] = (uint8_t)(G_host[r] & 255);
  const long long tiles = (C + kTile - 1) / kTile;
  const bool vec = (C % kVec == 0) && aligned16(P) && aligned16(old) &&
                   aligned16(nw) && aligned16(out);
  const int grid = grid_for(tiles, 8);
  delta_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables, G, m, P, old, nw, out, C, tiles, vec);
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
