// Causal flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// flash_attention replaces the Pallas kernel of the JAX package,
// src/repro/kernels/flash_attention.py:31 (_flash_kernel; its pallas_call
// at :77): softmax(Q K^T / sqrt(hd)) V per head with the scores, the
// online-softmax statistics and the P V sum in fp32, GQA (q head h reads
// KV head h / (H / KV)), causal by absolute positions or full, output in
// the input dtype.  Masked scores are -1e30, as in the reference, not
// -inf; keys at positions >= Skv are masked in every call.
//
// Query stripes.  A rank of a (data, model) mesh computes one stripe of
// the reference's striped Q tiles (src/repro/models/layers.py:189-295):
// its rows are segments of `seg` rows, segment j holding the positions of
// the reference's tile j * nstripes + stripe, so row r sits at position
// ((r / seg) * nstripes + stripe) * seg + r % seg (qpos below).  Only
// the causal test reads positions: a Q tile's causal KV-tile count is
// taken at its last row's position, its diagonal test at its first
// row's, and each row masks keys past its own position.  When seg is a
// multiple of the 64-row tile every tile's positions are contiguous;
// otherwise a tile may span two segments and the per-row test still
// holds.  nstripes = 1 is the unstriped kernel (qpos(r) = r).  q/k/v are read
// in place, in their (B, S, heads, hd) layout, through their strides.  hd
// is 16, 32, 64, 112, 128 or 256.
//
// Bound.  At starcoder2-3b's prefill shape (B 4, S 2048, H 24, KV 2,
// hd 128, bf16, causal) a call needs 4*B*H*hd*S(S+1)/2 = 1.03e11
// operations (0.104 ms at the card's 989 TFLOP/s bf16 peak) on 109 MB
// (0.033 ms at 3.35 TB/s): it is bound by operations.  The bf16 body
// splits P into two bf16 terms (below), so its tensor cores do 1.5 times
// that: 1.55e11 operations, a floor of 0.156 ms.
//
// bf16 body, flash_attention_wgmma_kernel<HD>:
//   * grid: one CTA of one warpgroup (128 threads) per (b*H + h, 64-row Q
//     tile), the heaviest tiles (the last rows of a causal call) first;
//     the KV loop stops at the causal diagonal.  At B 1, S 256 that is 96
//     CTAs for 132 SMs.  CTAs are small so that several share an SM (three
//     at hd 128: 49 KB of shared memory and 138 registers a thread each)
//     and one's softmax runs while another's wgmma does; two warpgroups
//     per CTA sharing K/V tiles ran in lockstep and were slower.
//   * loads: TMA, from 4-d tensor maps (hd, heads, S, B) that the host
//     builds from the byte strides (cuTensorMapEncodeTiled, found through
//     cudaGetDriverEntryPoint), in boxes of 64 rows by one swizzle span:
//     128 B at hd 64 and 128 (hd 128 as two 64-column panels), 64 B at
//     hd 32, 32 B at hd 16, into shared memory aligned to 1024 B.  Q loads
//     once.  K and V tiles of 64 keys go through one ring of kSlots = 2
//     slots in the order K0, V0, K1, V1, ..., each slot on an mbarrier
//     with expect_tx: thread 0 refills a slot once the warpgroup has read
//     it, so the next K loads while this V is used and the next V while
//     the next scores are computed (4 slots fit only two CTAs on an SM).
//     TMA fills rows past S with zeros, and a zero key scores 0, not
//     -1e30, so keys >= Skv are still masked here; rows >= Sq are not
//     stored.
//   * S = Q K^T: wgmma m64n64k16 with Q and K both read from shared memory
//     through descriptors (K-major), hd / 16 k-steps; the scores stay in
//     registers.
//   * online softmax in base 2 (the scale folded with log2 e) on the
//     accumulator layout, where a row lives in a quad of threads: its max
//     takes two shuffles.  Masks apply only on diagonal tiles and at the
//     Skv edge.
//   * O += P V: wgmma m64n{hd}k16 with P from registers (the S accumulator
//     is already in the A-fragment layout, no shared memory) and V from
//     shared memory as it lies, key-major, with the B operand transposed
//     (no transpose pass).  P is split into hi = bf16(p) and lo =
//     bf16(p - hi), two wgmma per k-step: one bf16 rounding of P puts
//     outputs 9 to 15 times the stated per-element bound off the plain
//     version (the CPU emulation of this body in tests/test_torch_flash.py),
//     the split about half of it.  The row sums add the fp32 p.
//   * epilogue: O / max(l, 1e-30), rounded to bf16, stored from registers.
//
// hd 112 (kimi-k2) takes the bf16 body with two 64-column panels; the
// tensor maps zero-fill the second panel's last 16 columns, zero q and k
// columns add 0 to Q K^T (7 k-steps of 16), O += P V is a wgmma
// m64n112k16, and the epilogue stores columns 0..111 alone.
//
// hd 256 (recurrentgemma-2b): one warpgroup's O accumulator would take
// 128 of a thread's 255 registers before S and P's two terms, so the CTA
// has two consumer warpgroups (256 threads, Split<256>): both compute the
// same S = Q K^T (16 k-steps) and the same P, and each accumulates 128
// columns of O from its half of the V tile (two of its four panels).  Q
// takes 32 KB of shared memory and each ring slot 32 KB: 97 KB a CTA.
//
// fp32 body, flash_attention_kernel<HD>: on the CUDA cores, since TF32
// tensor cores keep about 10 bits and cannot hold the fp32 bound of 1e-4.
// One block of 256 threads per (b*H + h, 64-row Q tile), KV tiles of 64
// up to the diagonal; a thread owns a 4 x 4 tile of the scores and 4 rows
// x hd/16 columns of the output, so a 16-byte shared load feeds 8 or more
// FMAs; rows padded by 4 floats against bank conflicts; the next K or V
// tile loads into registers while the current one is used, and two blocks
// share an SM (one at hd 256, whose 150 KB of shared memory takes the
// opt-in above 48 KB).
//
// Later work on the bf16 body: a producer warp with setmaxnreg, ping-pong
// between two consumer warpgroups, overlapping the softmax with the next
// Q K^T, persistent CTAs, clusters with multicast loads, one CTA per GQA
// group, fp8.
//
// The entry point launches on the stream it is given, allocates nothing,
// and returns a CUDA error code (cudaGetLastError() after the launch, or
// the tensor maps' failure) so the caller can raise.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// the position of local query row r in a stripe (the notes above)
__device__ __forceinline__ int qpos(int r, int seg, int nstripes,
                                    int stripe) {
  return nstripes == 1 ? r : ((r / seg) * nstripes + stripe) * seg + r % seg;
}

enum Dtype { kF32 = 0, kBF16 = 1 };

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // Q rows per block
constexpr int kBK = 64;        // K/V rows per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns rows, tx owns keys/cols
constexpr int kPad = 4;        // floats of padding per staged row

// 16-byte chunks (4 floats) of a 64-row tile that one thread loads
template <int HD>
struct Tile {
  static constexpr int kChunksPerRow = HD / 4;
  static constexpr int kChunks = kBQ * kChunksPerRow;
  static constexpr int kPerThread = (kChunks + kThreads - 1) / kThreads;
};

// Load a 64-row tile of (rows, HD) from device memory into registers:
// row r sits at base + (row0 + r) * stride; rows at or past `rows` read
// as zeros.
template <int HD>
__device__ __forceinline__ void load_tile(uint4 (&reg)[Tile<HD>::kPerThread],
                                          const float* base, long long stride,
                                          int row0, int rows) {
  using TL = Tile<HD>;
#pragma unroll
  for (int u = 0; u < TL::kPerThread; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int r = c / TL::kChunksPerRow;
    const int e = (c % TL::kChunksPerRow) * 4;
    reg[u] = make_uint4(0, 0, 0, 0);
    if (c < TL::kChunks && row0 + r < rows)
      reg[u] = *reinterpret_cast<const uint4*>(
          base + (long long)(row0 + r) * stride + e);
  }
}

// Store a loaded tile into shared memory as rows of HD + kPad floats.
template <int HD>
__device__ __forceinline__ void store_tile(
    float* dst, const uint4 (&reg)[Tile<HD>::kPerThread]) {
  using TL = Tile<HD>;
#pragma unroll
  for (int u = 0; u < TL::kPerThread; ++u) {
    const int c = threadIdx.x + u * kThreads;
    if (c >= TL::kChunks) continue;
    const int r = c / TL::kChunksPerRow;
    const int e = (c % TL::kChunksPerRow) * 4;
    *reinterpret_cast<uint4*>(dst + r * (HD + kPad) + e) = reg[u];
  }
}

// Output columns of a thread: NV vectors of CW floats; vector n, element e
// is column n * 16 * CW + tx * CW + e (consecutive threads on consecutive
// addresses, no bank conflicts).
template <int HD>
struct Cols {
  static constexpr int CW = HD % 64 == 0 ? 4 : HD % 32 == 0 ? 2 : 1;
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

template <int CW>
__device__ __forceinline__ void stg(float* p, const float* v) {
  if constexpr (CW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (CW == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
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
  int seg, nstripes, stripe;  // query rows' positions (qpos)
};

template <int HD>
constexpr int smem_floats() {
  // Q tile, one K-or-V tile, the 64 x 64 probabilities
  return kBQ * (HD + kPad) + kBK * (HD + kPad) + kBQ * (kBK + kPad);
}

// blocks of the CUDA-core body an SM holds: its shared memory allows one
// at hd 256
template <int HD>
constexpr int blocks_per_sm() {
  return HD > 128 ? 1 : 2;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<HD>())
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

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb =
      static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb =
      static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int nkv = (a.Skv + kBK - 1) / kBK;
  int ntiles = nkv;
  if (a.causal) {
    const int q_last =
        qpos(min(q0 + kBQ, a.Sq) - 1, a.seg, a.nstripes, a.stripe);
    ntiles = min(nkv, q_last / kBK + 1);
  }
  int qps[4];  // positions of this thread's rows
#pragma unroll
  for (int i = 0; i < 4; ++i)
    qps[i] = qpos(q0 + ty + 16 * i, a.seg, a.nstripes, a.stripe);

  uint4 reg[Tile<HD>::kPerThread];
  load_tile<HD>(reg, qb, a.q_ss, q0, a.Sq);
  store_tile<HD>(Qs, reg);
  load_tile<HD>(reg, kb, a.k_ss, 0, a.Skv);

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
    store_tile<HD>(KVs, reg);  // K tile t
    __syncthreads();
    load_tile<HD>(reg, vb, a.v_ss, k0, a.Skv);  // V tile t, in flight

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
      const int qp = qps[i];
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
    store_tile<HD>(KVs, reg);  // V tile t
    __syncthreads();
    if (t + 1 < ntiles)
      load_tile<HD>(reg, kb, a.k_ss, k0 + kBK, a.Skv);  // K tile t + 1

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

  float* ob = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int qp = q0 + ty + 16 * i;
    if (qp >= a.Sq) continue;
    float* row = ob + (((long long)b * a.Sq + qp) * a.H + h) * HD;
#pragma unroll
    for (int n = 0; n < C::NV; ++n) {
      float out[C::CW];
#pragma unroll
      for (int e = 0; e < C::CW; ++e) out[e] = acc[i][n * C::CW + e] * inv;
      stg<C::CW>(row + C::col(n, tx), out);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed shared memory
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // Q rows per CTA; keys per K or V tile
constexpr int kSlots = 2;  // the ring of K and V tiles (K0, V0, K1, ...)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// one arrival that also announces `bytes` of TMA data to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// until the phase of `bar` with parity `parity` has completed.  A load
// that never lands (a fault) traps after about 2^34 cycles rather than
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// one box of the tensor map at (column, head, row, batch) into shared
// memory at dst, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head),
        "r"(row), "r"(batch), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B,
// 3: 32 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p0, p1 as two bf16x2 terms: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_bf16x2(float p0, float p1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// D (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), both bf16 read from shared
// memory through descriptors, both K-major; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, fp32) += A (64 x 16, bf16 in registers) B (16 x 16), B read
// from shared memory MN-major (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 in registers) B (16 x 32), B read
// from shared memory MN-major (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers) B (16 x 64), B read
// from shared memory MN-major (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 112, fp32) += A (64 x 16, bf16 in registers) B (16 x 112), B
// read from shared memory MN-major (imm-trans-b = 1): hd 112
__device__ __forceinline__ void wgmma_rs(float (&d)[56],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers) B (16 x 128), B read
// from shared memory MN-major (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A 64-row tile of hd columns in shared memory: ceil(hd / kCols) panels
// of kRows x kCols, each row one swizzle span (the TMA box and the wgmma
// swizzle atom agree), 8-row groups kSBO bytes apart.  At hd 112 the
// second panel's last 16 columns are the tensor map's zero fill.
template <int HD>
struct Panels {
  static constexpr int kCols = HD < 64 ? HD : 64;
  static constexpr int kCount = (HD + kCols - 1) / kCols;
  static constexpr int kBytes = kRows * kCols * 2;
  static constexpr int kTileBytes = kCount * kBytes;
  static constexpr uint32_t kSBO = 8 * kCols * 2;
  static constexpr uint64_t kLayout = kCols == 64 ? 1 : kCols == 32 ? 2 : 3;
};

// shared memory of a CTA: the Q tile, the ring's slots, the barriers (Q,
// then one per slot), and slack to align the start to 1024 B
template <int HD>
struct Layout {
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + Panels<HD>::kTileBytes;
  static constexpr int kBar = kRing + kSlots * Panels<HD>::kTileBytes;
  static constexpr int kBytes = kBar + 8 * (1 + kSlots) + 1024;
};

struct TmaArgs {
  __nv_bfloat16* o;
  int Sq, Skv, H, KV;
  float scale_log2;  // log2(e) / sqrt(hd): the scores in base 2
  int causal;
  int seg, nstripes, stripe;  // query rows' positions (qpos)
};

template <int HD>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int row,
                                          int batch) {
  using P = Panels<HD>;
#pragma unroll
  for (int p = 0; p < P::kCount; ++p)
    tma_load(dst + p * P::kBytes, map, bar, p * P::kCols, head, row, batch);
}

// Consumer warpgroups of a CTA and the O columns each owns: at hd 256
// one warpgroup's O accumulator would take 128 of a thread's 255
// registers beside S and P's two terms, so two warpgroups split hd, each
// computing the same S and P and accumulating 128 columns of O.
template <int HD>
struct Split {
  static constexpr int kWG = HD > 128 ? 2 : 1;
  static constexpr int kCols = HD / kWG;
  static constexpr int kThreads = 128 * kWG;
};

template <int HD>
__global__ void __launch_bounds__(Split<HD>::kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const TmaArgs a) {
  using P = Panels<HD>;
  using L = Layout<HD>;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t q_bar = base + L::kBar;
  // load n of the ring is K (n even) or V (n odd) of tile n / 2, in slot
  // n % kSlots, on that slot's barrier for the (n / kSlots)-th time
  auto slot = [&](int n) {
    return base + L::kRing + n % kSlots * P::kTileBytes;
  };
  auto slot_bar = [&](int n) { return q_bar + 8 * (1 + n % kSlots); };
  auto slot_wait = [&](int n) {
    mbar_wait(slot_bar(n), (uint32_t)(n / kSlots) & 1);
  };

  constexpr int ON = Split<HD>::kCols;  // O columns of this warpgroup
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = tid % 128 / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KV);
  // the heaviest Q tiles (the most KV tiles under a causal mask) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int nkv = (a.Skv + kRows - 1) / kRows;
  // KV tiles up to the diagonal of the tile's last row if causal
  const int ntiles =
      a.causal ? min(nkv, qpos(min(q0 + kRows, a.Sq) - 1, a.seg, a.nstripes,
                               a.stripe) / kRows + 1)
               : nkv;
  const int p0 = qpos(q0, a.seg, a.nstripes, a.stripe);  // the first row's

  const int nloads = 2 * ntiles;
  auto load = [&](int n) {  // thread 0 only
    if (n >= nloads) return;
    mbar_expect_tx(slot_bar(n), P::kTileBytes);
    load_rows<HD>(slot(n), n % 2 ? &tv : &tk, slot_bar(n), kvh,
                  n / 2 * kRows, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kSlots; ++i) mbar_init(q_bar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, P::kTileBytes);
    load_rows<HD>(sQ, &tq, q_bar, h, q0, b);
    for (int n = 0; n < kSlots; ++n) load(n);
  }

  // accumulator layout of wgmma m64nN: thread (warp, lane) holds rows
  // r and r + 8, r = 16 warp + lane / 4; value 4j + 2i + e is row r + 8i,
  // column 8j + c + e with c = 2 (lane % 4)
  const int r = warp * 16 + lane / 4;
  const int c = 2 * (lane % 4);
  const int qps[2] = {qpos(q0 + r, a.seg, a.nstripes, a.stripe),
                      qpos(q0 + r + 8, a.seg, a.nstripes, a.stripe)};
  float o[ON / 2];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's sum
#pragma unroll
  for (int i = 0; i < ON / 2; ++i) o[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kRows;
    // S = Q K^T over hd / 16 k-steps, both operands K-major (the first
    // step overwrites sc)
    float sc[32];
    slot_wait(2 * t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk * 16 / P::kCols) * P::kBytes +
                           (kk * 16 % P::kCols) * 2;
      wgmma_ss_n64(
          sc, smem_desc(sQ + off, 16, P::kSBO, P::kLayout),
          smem_desc(slot(2 * t) + off, 16, P::kSBO, P::kLayout), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    __syncthreads();  // every warp has read K: refill its slot
    if (tid == 0) load(2 * t + kSlots);

    // online softmax in base 2; masks only on the diagonal and the
    // Skv edge
    const bool edge = (a.causal && k0 + kRows - 1 > p0) || k0 + kRows > a.Skv;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = qps[i];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * j + 2 * i + e] * a.scale_log2;
          if (edge) {
            const int kp = k0 + 8 * j + c + e;
            if (kp >= a.Skv || (a.causal && kp > qp)) x = kNegInf;
          }
          sc[4 * j + 2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(sc[4 * j + 2 * i + e] - m_new);
          sc[4 * j + 2 * i + e] = p;
          sum += p;
        }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < ON / 8; ++j) {
        o[4 * j + 2 * i] *= alpha;
        o[4 * j + 2 * i + 1] *= alpha;
      }
    }

    // P as wgmma A fragments (16 keys per k-step), split hi + lo: the
    // accumulator's pairs are the fragment's registers in the order
    // (row r, keys c..), (r + 8, c..), (r, 8 + c..), (r + 8, 8 + c..)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = 4 * (2 * kk + u / 2) + 2 * (u % 2);
        split_bf16x2(sc[idx], sc[idx + 1], ph[kk][u], pl[kk][u]);
      }

    // O += P V: V read key-major, the B operand transposed; this
    // warpgroup's columns start at panel wg * ON / 64
    slot_wait(2 * t + 1);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = smem_desc(
          slot(2 * t + 1) + wg * (ON / P::kCols) * P::kBytes +
              kk * 16 * P::kCols * 2,
          P::kBytes, P::kSBO, P::kLayout);
      wgmma_rs(o, ph[kk], dv);
      wgmma_rs(o, pl[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // and V
    if (tid == 0) load(2 * t + 1 + kSlots);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r + 8 * i;
    if (qp >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* row =
        a.o + (((long long)b * a.Sq + qp) * a.H + h) * HD + wg * ON + c;
#pragma unroll
    for (int j = 0; j < ON / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
  }
}

template <int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * a.H), (unsigned)((a.Sq + kBQ - 1) / kBQ));
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch_f32(const Args& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(a, B, stream);
    case 32: return launch<32>(a, B, stream);
    case 64: return launch<64>(a, B, stream);
    case 112: return launch<112>(a, B, stream);
    case 128: return launch<128>(a, B, stream);
    case 256: return launch<256>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cuTensorMapEncodeTiled, looked up in the driver at run time (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-d map (hd, heads, S, B) of a bf16 q, k or v with element strides
// (head, seq, batch), boxes of kRows rows by one panel.  A dimension of
// extent 1 takes the span of the ones inside it as its stride (torch
// gives such a dimension any stride).
int make_map(CUtensorMap* map, const void* base, int hd, int heads, int S,
             int B, long long sh, long long ss, long long sb) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int cols = hd < 64 ? hd : 64;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const long long elems[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  cuuint64_t span = (cuuint64_t)hd * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? span : (cuuint64_t)elems[i] * 2;
    span = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_wgmma(const CUtensorMap (&maps)[3], const TmaArgs& a, int B,
                 cudaStream_t stream) {
  constexpr int smem = Layout<HD>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * a.H), (unsigned)((a.Sq + kRows - 1) / kRows));
  flash_attention_wgmma_kernel<HD>
      <<<grid, Split<HD>::kThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                                    a);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const CUtensorMap (&maps)[3], const TmaArgs& a, int B,
                  int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_wgmma<16>(maps, a, B, stream);
    case 32: return launch_wgmma<32>(maps, a, B, stream);
    case 64: return launch_wgmma<64>(maps, a, B, stream);
    case 112: return launch_wgmma<112>(maps, a, B, stream);
    case 128: return launch_wgmma<128>(maps, a, B, stream);
    case 256: return launch_wgmma<256>(maps, a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k/v (B, Skv, KV, hd) with element strides (batch,
// seq, head) and a unit stride on hd; o is a contiguous (B, Sq, H, hd)
// tensor of the same dtype.  dtype: 0 float32 (the CUDA-core body),
// 1 bfloat16 (the wgmma body).  seg, nstripes, stripe: the query rows'
// positions (qpos; nstripes = 1 for rows at positions 0..Sq-1).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Skv, int H, int KV, int hd,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    float scale, int causal, int seg, int nstripes,
                    int stripe, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      (long long)(Sq + kBQ - 1) / kBQ > 65535 || nstripes < 1 ||
      stripe < 0 || stripe >= nstripes || (nstripes > 1 && seg < 1) ||
      (nstripes > 1 &&
       ((long long)(Sq - 1) / seg * nstripes + nstripes) * seg > 2147483647LL))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const Args a{q, k, v, o, Sq, Skv, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss,
                 k_sh, v_sb, v_ss, v_sh, scale, causal, seg, nstripes,
                 stripe};
    return dispatch_f32(a, B, hd, s);
  }
  if (dtype != kBF16) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  int e = make_map(&maps[0], q, hd, H, Sq, B, q_sh, q_ss, q_sb);
  if (e == 0) e = make_map(&maps[1], k, hd, KV, Skv, B, k_sh, k_ss, k_sb);
  if (e == 0) e = make_map(&maps[2], v, hd, KV, Skv, B, v_sh, v_ss, v_sb);
  if (e != 0) return e;
  const TmaArgs a{static_cast<__nv_bfloat16*>(o), Sq, Skv, H, KV,
                  scale * 1.4426950408889634f, causal, seg, nstripes,
                  stripe};
  return dispatch_bf16(maps, a, B, hd, s);
}

}  // extern "C"
