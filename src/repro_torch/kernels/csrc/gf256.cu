// GF(2^8) coding kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// These replace the Pallas kernels that carry the RS/XOR (r = 1) coding
// data plane of the JAX package:
//
//   gf_matmul_batched    <- kernels/gf256_matmul.py:_gf_matmul_batched_kernel
//   gf_per_item_fold     <- kernels/gf256_matmul.py:_per_item_fold_kernel
//   gf_delta_apply_batched <- kernels/delta_update.py:_delta_apply_batched_kernel
//   gf_delta_only_batched  <- kernels/delta_update.py:_delta_only_batched_kernel
//
// The Pallas bodies decompose every product into 8 bit-planes because the
// TPU's vector unit cannot gather bytes.  A GPU gathers from shared memory
// cheaply, so here a GF(2^8) product is a table lookup:
//
//   * gf_matmul_batched keeps one 256-byte MUL_TABLE row per coefficient
//     of the shared (m, k) matrix in shared memory (m*k*256 bytes, 20 KB
//     at (10, 8)): one lookup per product;
//   * the per-item kernels (coefficients differ per batch item) keep the
//     512-byte EXP and 256-byte LOG tables in shared memory:
//     g*x = x ? EXP[LOG[x] + LOG[g]] : 0, with LOG[x] taken once per input
//     byte and shared by every output row.
//
// Work split: a block is 256 threads and each thread owns 16 contiguous
// bytes of one column tile (4096 bytes per tile).  Blocks walk the
// (item, tile) units grid-stride, so the shared-memory tables are built
// once per block and reused across items.  When C is a multiple of 16 and
// every pointer is 16-byte aligned the bytes move as one 16-byte vector
// load/store per thread; otherwise (C = 1000, say) the same loop runs a
// byte at a time and masks the ragged tail.
//
// Bound: each kernel moves every input byte once and every output byte
// once; at the shapes of the coding path that is far below the card's
// compute, so the floor is device-memory bandwidth.  The design keeps the
// tables on chip (no global gathers), loads inputs once per thread into
// registers (the matmul re-reads its k input vectors per output row from
// L1), and writes each output byte once.  Shared-memory byte gathers with
// bank conflicts are the expected limit of this first version.
//
// Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;
constexpr int kTile = kThreads * kVec;
// shared (m, k) matrix: its coefficients travel in the kernel parameters,
// and its MUL_TABLE rows (m*k*256 bytes) must fit in shared memory
constexpr int kMaxCoefs = 896;

// Layout of the device table buffer the wrapper passes in:
// MUL_TABLE (256*256) | EXP_TABLE (512) | LOG_TABLE as bytes (256).
constexpr int kMulOff = 0;
constexpr int kExpOff = 65536;
constexpr int kLogOff = 65536 + 512;

struct Coefs {
  uint8_t a[kMaxCoefs];
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

// out[b, o] = P[b, o] ^ XOR_j Ms[b, o, j] * D[b, j]; Ms (B, O, J) uint8,
// D (B, J, C), P and out (B, O, C).
__global__ void __launch_bounds__(kThreads)
per_item_fold_kernel(const uint8_t* __restrict__ tables,
                     const uint8_t* __restrict__ Ms,
                     const uint8_t* __restrict__ P,
                     const uint8_t* __restrict__ D, uint8_t* __restrict__ out,
                     int B, int O, int J, long long C, long long tiles,
                     bool vec) {
  __shared__ uint8_t exp_s[512];
  __shared__ uint8_t log_s[256];
  load_exp_log(tables, exp_s, log_s);
  const long long units = (long long)B * tiles;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long b = u / tiles;
    const long long c0 = (u % tiles) * kTile + (long long)threadIdx.x * kVec;
    if (c0 >= C) continue;
    const int nb = (int)min((long long)kVec, C - c0);
    const uint8_t* mb = Ms + b * O * J;
    for (int o = 0; o < O; ++o) {
      V16 acc = load16(P + (b * O + o) * C + c0, nb, vec);
      for (int j = 0; j < J; ++j) {
        const int g = mb[o * J + j];
        if (g == 0) continue;
        const int lg = log_s[g];
        const V16 x = load16(D + (b * J + j) * C + c0, nb, vec);
#pragma unroll
        for (int t = 0; t < kVec; ++t) {
          const int xb = x.b[t];
          acc.b[t] ^= xb ? exp_s[log_s[xb] + lg] : (uint8_t)0;
        }
      }
      store16(out + (b * O + o) * C + c0, acc, nb, vec);
    }
  }
}

// out[b, r] = (P[b, r] ^) G[b, r] * X[b]; G (B, m) int32, X (B, C),
// P and out (B, m, C).  HAS_PARITY = false is the delta-only body.
template <bool HAS_PARITY>
__global__ void __launch_bounds__(kThreads)
delta_batched_kernel(const uint8_t* __restrict__ tables,
                     const int32_t* __restrict__ G,
                     const uint8_t* __restrict__ P,
                     const uint8_t* __restrict__ X, uint8_t* __restrict__ out,
                     int B, int m, long long C, long long tiles, bool vec) {
  __shared__ uint8_t exp_s[512];
  __shared__ uint8_t log_s[256];
  load_exp_log(tables, exp_s, log_s);
  const long long units = (long long)B * tiles;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long b = u / tiles;
    const long long c0 = (u % tiles) * kTile + (long long)threadIdx.x * kVec;
    if (c0 >= C) continue;
    const int nb = (int)min((long long)kVec, C - c0);
    const V16 x = load16(X + b * C + c0, nb, vec);
    V16 lx;
#pragma unroll
    for (int t = 0; t < kVec; ++t) lx.b[t] = log_s[x.b[t]];
    for (int r = 0; r < m; ++r) {
      V16 acc;
      if (HAS_PARITY) {
        acc = load16(P + (b * m + r) * C + c0, nb, vec);
      } else {
        acc.q = make_uint4(0u, 0u, 0u, 0u);
      }
      const int g = G[b * m + r] & 255;
      if (g != 0) {
        const int lg = log_s[g];
#pragma unroll
        for (int t = 0; t < kVec; ++t)
          acc.b[t] ^= x.b[t] ? exp_s[lx.b[t] + lg] : (uint8_t)0;
      }
      store16(out + (b * m + r) * C + c0, acc, nb, vec);
    }
  }
}

int grid_for(long long units, int blocks_per_sm) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = (long long)sms * blocks_per_sm;
  return (int)(units < cap ? units : cap);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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

int gf_per_item_fold(const uint8_t* tables, const uint8_t* Ms,
                     const uint8_t* P, const uint8_t* D, uint8_t* out, int B,
                     int O, int J, long long C, void* stream) {
  if (O <= 0 || J <= 0 || B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (C + kTile - 1) / kTile;
  const bool vec = (C % kVec == 0) && aligned16(P) && aligned16(D) &&
                   aligned16(out);
  const int grid = grid_for((long long)B * tiles, 8);
  per_item_fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables, Ms, P, D, out, B, O, J, C, tiles, vec);
  return (int)cudaGetLastError();
}

static int launch_delta(bool has_parity, const uint8_t* tables,
                        const int32_t* G, const uint8_t* P, const uint8_t* X,
                        uint8_t* out, int B, int m, long long C,
                        void* stream) {
  if (m <= 0 || B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (C + kTile - 1) / kTile;
  const bool vec = (C % kVec == 0) && aligned16(X) && aligned16(out) &&
                   (!has_parity || aligned16(P));
  const int grid = grid_for((long long)B * tiles, 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_parity)
    delta_batched_kernel<true><<<grid, kThreads, 0, s>>>(tables, G, P, X, out,
                                                         B, m, C, tiles, vec);
  else
    delta_batched_kernel<false><<<grid, kThreads, 0, s>>>(
        tables, G, nullptr, X, out, B, m, C, tiles, vec);
  return (int)cudaGetLastError();
}

int gf_delta_apply_batched(const uint8_t* tables, const int32_t* G,
                           const uint8_t* P, const uint8_t* X, uint8_t* out,
                           int B, int m, long long C, void* stream) {
  return launch_delta(true, tables, G, P, X, out, B, m, C, stream);
}

int gf_delta_only_batched(const uint8_t* tables, const int32_t* G,
                          const uint8_t* X, uint8_t* out, int B, int m,
                          long long C, void* stream) {
  return launch_delta(false, tables, G, nullptr, X, out, B, m, C, stream);
}

}  // extern "C"
