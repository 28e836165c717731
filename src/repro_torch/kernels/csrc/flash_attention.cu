// Causal flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// flash_attention replaces the Pallas kernel kernels/flash_attention.py:
// _flash_kernel of the JAX package: softmax(Q K^T / sqrt(hd)) V with the
// scores, the online-softmax statistics and the P.V sum in fp32, from bf16
// or fp32 inputs, GQA (q head h reads KV head h / (H / KV)), causal or
// full, output in the input dtype.  Masked scores are NEG_INF = -1e30, as
// in the reference, not -inf.
//
// Bound.  At the prefill shape of starcoder2-3b (B = 4, S = 2048, H = 24,
// KV = 2, hd = 128, bf16) one causal call needs 4*B*H*hd*S(S+1)/2 =
// 1.03e11 operations (0.104 ms at the card's 989 TFLOP/s bf16 peak) and
// moves 109 MB (q, k, v and the output once: 0.033 ms at 3.35 TB/s).  It
// is bound by operations.  This first kernel runs them on the CUDA cores
// in fp32 (67 TFLOP/s peak), so it cannot come near that bound; what the
// design does about the operations:
//
//   * the TPU grid (BH, nq, nkv) visited every KV tile and masked the
//     ones above the diagonal; here one block owns one (b*H + h, 64-row Q
//     tile) and loops over KV tiles of 64 rows, stopping at the tile that
//     holds the diagonal for a causal call: half the work;
//   * blocks of the heaviest Q tiles (the last rows of a causal call)
//     launch first, so the short ones fill the tail of the grid;
//   * each thread owns a 4 x 4 tile of the 64 x 64 score block (rows
//     ty + 16i, keys tx + 16j) and 4 rows x hd/16 columns of the output,
//     so every 16-byte shared-memory load feeds 8 or more FMAs; the Q and
//     K rows are padded by 4 floats so the loads of a quarter-warp fall in
//     distinct banks;
//   * the running max, the denominator (as per-thread partial sums) and
//     the output rows stay in the registers of the threads that own those
//     Q rows; a row's max is reduced over its 16 threads with shuffles;
//   * the next K or V tile is loaded from device memory into registers
//     while the current one is computed on, and two blocks fit on an SM
//     (85 KB of shared memory each at hd = 128), so one block's loads
//     overlap the other's arithmetic.
//
// Inputs are read in their (B, S, heads, hd) layout through strides, the
// KV head by index: no transpose, no expanded K/V and no padded copy.
// Ragged Q rows and K columns (S not a multiple of 64) are masked here;
// keys at positions >= Skv never enter the softmax, whether or not the
// call is causal.  hd is 16, 32, 64 or 128.
//
// tensor cores (mma.sync / wgmma for Q K^T and P V), TMA loads, and one
// block per KV head serving its whole group of Q heads are later work.
//
// The entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // Q rows per block
constexpr int kBK = 64;        // K/V rows per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns rows, tx owns keys/cols
constexpr int kPad = 4;        // floats of padding per staged row

enum Dtype { kF32 = 0, kBF16 = 1 };

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;  // elements per 16-byte load
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

// 16-byte chunks of a 64-row tile that one thread loads
template <int HD, typename T>
struct Tile {
  static constexpr int kChunksPerRow = HD / Vec<T>::n;
  static constexpr int kChunks = kBQ * kChunksPerRow;
  static constexpr int kPerThread = (kChunks + kThreads - 1) / kThreads;
};

// Load a 64-row tile of (rows, HD) from device memory into registers:
// row r sits at base + (row0 + r) * stride; rows at or past `rows` read
// as zeros.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(uint4 (&reg)[Tile<HD, T>::kPerThread],
                                          const T* base, long long stride,
                                          int row0, int rows) {
  using TL = Tile<HD, T>;
#pragma unroll
  for (int u = 0; u < TL::kPerThread; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int r = c / TL::kChunksPerRow;
    const int e = (c % TL::kChunksPerRow) * Vec<T>::n;
    reg[u] = make_uint4(0, 0, 0, 0);
    if (c < TL::kChunks && row0 + r < rows)
      reg[u] = *reinterpret_cast<const uint4*>(
          base + (long long)(row0 + r) * stride + e);
  }
}

// Store a loaded tile into shared memory as fp32 rows of HD + kPad.
template <int HD, typename T>
__device__ __forceinline__ void store_tile(
    float* dst, const uint4 (&reg)[Tile<HD, T>::kPerThread]) {
  using TL = Tile<HD, T>;
#pragma unroll
  for (int u = 0; u < TL::kPerThread; ++u) {
    const int c = threadIdx.x + u * kThreads;
    if (c >= TL::kChunks) continue;
    const int r = c / TL::kChunksPerRow;
    const int e = (c % TL::kChunksPerRow) * Vec<T>::n;
    float* row = dst + r * (HD + kPad) + e;
    if constexpr (Vec<T>::n == 4) {
      *reinterpret_cast<uint4*>(row) = reg[u];
    } else {
      const __nv_bfloat162* h =
          reinterpret_cast<const __nv_bfloat162*>(&reg[u]);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 c2 = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
      *reinterpret_cast<float4*>(row) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(row + 4) = make_float4(c2.x, c2.y, d.x, d.y);
    }
  }
}

// Output columns of a thread: NV vectors of CW floats; vector n, element e
// is column n * 16 * CW + tx * CW + e (consecutive threads on consecutive
// addresses, no bank conflicts).
template <int HD>
struct Cols {
  static constexpr int CW = HD >= 64 ? 4 : HD / 16;
  static constexpr int NV = HD / (16 * CW);
  static constexpr int N = CW * NV;  // columns per thread
  __device__ static __forceinline__ int col(int n, int tx) {
    return n * 16 * CW + tx * CW;
  }
};

template <int CW>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (CW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (CW == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

template <typename T, int CW>
__device__ __forceinline__ void stg(T* p, const float* v) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (CW == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else if constexpr (CW == 2)
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    else
      *reinterpret_cast<float*>(p) = v[0];
  } else {
    if constexpr (CW == 4) {
      __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                             __floats2bfloat162_rn(v[2], v[3])};
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<uint2*>(h);
    } else if constexpr (CW == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    } else {
      *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16(v[0]);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

template <int HD>
constexpr int smem_floats() {
  // Q tile, one K-or-V tile, the 64 x 64 probabilities
  return kBQ * (HD + kPad) + kBK * (HD + kPad) + kBQ * (kBK + kPad);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + kBQ * (HD + kPad);
  float* Ps = KVs + kBK * (HD + kPad);
  constexpr int QS = HD + kPad;
  constexpr int PS = kBK + kPad;
  using C = Cols<HD>;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  // the heaviest Q tiles (the most KV tiles under a causal mask) first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kBQ;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int nkv = (a.Skv + kBK - 1) / kBK;
  int ntiles = nkv;
  if (a.causal) {
    const int q_last = min(q0 + kBQ, a.Sq) - 1;
    ntiles = min(nkv, q_last / kBK + 1);
  }

  uint4 reg[Tile<HD, T>::kPerThread];
  load_tile<HD, T>(reg, qb, a.q_ss, q0, a.Sq);
  store_tile<HD, T>(Qs, reg);
  load_tile<HD, T>(reg, kb, a.k_ss, 0, a.Skv);

  float acc[4][C::N];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    store_tile<HD, T>(KVs, reg);  // K tile t
    __syncthreads();
    load_tile<HD, T>(reg, vb, a.v_ss, k0, a.Skv);  // V tile t, in flight

    // S = Q K^T for rows ty + 16i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QS + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // scale, mask, online softmax; p goes to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < a.Skv && (!a.causal || qp >= kp);
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < C::N; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // K no longer read; P visible
    store_tile<HD, T>(KVs, reg);  // V tile t
    __syncthreads();
    if (t + 1 < ntiles)
      load_tile<HD, T>(reg, kb, a.k_ss, k0 + kBK, a.Skv);  // K tile t + 1

    // acc += P V
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[C::N];
#pragma unroll
        for (int n = 0; n < C::NV; ++n)
          lds<C::CW>(&KVs[(kk + u) * QS + C::col(n, tx)], &vv[n * C::CW]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y
                         : u == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int c = 0; c < C::N; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();  // V and P no longer read
  }

  T* ob = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int qp = q0 + ty + 16 * i;
    if (qp >= a.Sq) continue;
    T* row = ob + (((long long)b * a.Sq + qp) * a.H + h) * HD;
#pragma unroll
    for (int n = 0; n < C::NV; ++n) {
      float out[C::CW];
#pragma unroll
      for (int e = 0; e < C::CW; ++e) out[e] = acc[i][n * C::CW + e] * inv;
      stg<T, C::CW>(row + C::col(n, tx), out);
    }
  }
}

template <int HD, typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<HD, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * a.H), (unsigned)((a.Sq + kBQ - 1) / kBQ));
  flash_attention_kernel<HD, T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const Args& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, T>(a, B, stream);
    case 32: return launch<32, T>(a, B, stream);
    case 64: return launch<64, T>(a, B, stream);
    case 128: return launch<128, T>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k/v (B, Skv, KV, hd) with element strides (batch,
// seq, head) and a unit stride on hd; o is a contiguous (B, Sq, H, hd)
// tensor of the same dtype.  dtype: 0 float32, 1 bfloat16.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Skv, int H, int KV, int hd,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      (long long)(Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, Sq, Skv, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss,
               k_sh, v_sb, v_ss, v_sh, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_hd<float>(a, B, hd, s);
  if (dtype == kBF16) return dispatch_hd<__nv_bfloat16>(a, B, hd, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
