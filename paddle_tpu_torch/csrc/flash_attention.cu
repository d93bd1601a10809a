// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV, each a
// hand-written kernel behind a plain C entry point (ops/flash_attention.py
// binds them with ctypes).
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py, each in an f32 build and a bf16
// build:
//   * forward <- `_fwd_kernel` (launched by `_mha_forward`): online-softmax
//     forward, writes O and a per-row logsumexp. f32: flash_fwd_kernel;
//     bf16: flash_fwd_wgmma_kernel;
//   * dQ <- `_dq_kernel` (launched by `_mha_backward`): recomputes P from
//     the logsumexp, dS = P * (dP - delta) * scale, dQ = dS . K. f32:
//     flash_dq_kernel; bf16: flash_dq_wgmma_kernel;
//   * dK/dV <- `_dkv_kernel` (launched by `_mha_backward`): dV = P_drop^T .
//     dO and dK = dS^T . Q, per query head. f32: flash_dkv_kernel; bf16:
//     flash_dkv_wgmma_kernel.
//
// Semantics kept from the TPU kernels, to the rounding: scores are
// (q . k) * scale in f32; the additive mask is added and the sum clamped at
// -1e30 (NaN propagates, as jnp.maximum does); causal positions above the
// diagonal are filled with -1e30; p = 0 where the score is <= -0.5e30; a row
// with l == 0 writes exact zeros and lse = m + log(1); the dropout keep mask
// is the murmur3 finalizer of the absolute (row, col), the seed and the
// flattened (batch * H + head) index, and kept values are divided by
// (1 - rate) in PV, in dP and in P^T for dV, while dS uses the undropped P;
// bf16 inputs round P to bf16 before PV, dS before dS.K and dS^T.Q, and the
// dropped P before P^T.dO, with every product accumulated in f32. GQA: query
// head b reads KV row (b / H) * Hk + (b % H) / (H / Hk); dK/dV come out per
// query head and the wrapper sums the group.
//
// Blocks. The Pallas grid walks (batch*head, q-block, k-block) in order on
// one core and carries the softmax state in scratch from one k-block to the
// next. Here blocks run in parallel in no order, so each thread block owns
// one (batch*head, row tile) and loops over the other axis itself:
//   * fwd and dq: one block per (b, q-tile), looping over k-tiles, and on
//     causal runs stopping at the tile that holds the diagonal;
//   * dkv: one block per (b, k-tile), looping over q-tiles, and on causal
//     runs starting at the diagonal tile.
// The backward kernels are separate and use no atomics, so their results
// repeat bit for bit from run to run. S may be any length: rows and columns
// past S load as zeros and score as masked.
//
// Bound on this card. At the GPT-350M training shape (B=8, H=16, S=1024,
// D=64, bf16, causal) attention does 4 * D flops per (query, key) pair in
// the forward, 6 * D in dq and 8 * D in dkv, against 4 * D bytes a row: the
// forward sits near the card's flop:byte balance (0.020 ms by bytes) and
// dkv above it (0.035 ms by operations at 989 TFLOP/s bf16). A block's
// time is latency first: loads it waits for, products it waits on, and
// the softmax between two products. The bf16 kernels are built for Hopper
// against that (primitives in hopper.cuh):
//   * a producer warp keeps a ring of K/V (forward, dQ) or Q/dO (dK/dV)
//     tiles in flight with TMA into 128B-swizzled shared memory, counted on
//     mbarriers, while two consumer warpgroups compute (setmaxnreg moves
//     registers from the producer to them); tensor maps are 3-D
//     [rows][S][D], so a box that reaches past S reads zeros;
//   * the products are `wgmma`: Q.K^T, dO.V^T, K.Q^T and V.dO^T with both
//     operands K-major in shared memory; P.V, dS.K, P_drop^T.dO and dS^T.Q
//     with the f32 score fragment rounded to bf16 in registers as A, and
//     V, K, dO or Q read as they lie through the transpose flag (no
//     transposed copies);
//   * exponentials are exp2f with scale * log2(e) folded into one FMA, and
//     only tiles that need it mask anything: the diagonal tile and a tile
//     past S by a compare an element. A mask or dropout selects a second
//     build of the same kernel (template flag kGeneral) that runs the
//     per-element rules of score() and keep() on every tile: that branchy
//     code, compiled into the plain build, takes its registers (spills,
//     serialized wgmma) and costs it 1.4x (forward) to 2.2x (dK/dV) at the
//     training shape on the H100;
//   * causal forward and dQ blocks start longest first (the last query
//     tile of every head is launched first); causal dK/dV blocks are
//     longest first in launch order already. In dQ, a warpgroup whose rows
//     end before a tile's first key skips the tile's products.
// The f32 builds run on the CUDA cores in full f32, which is what the f32
// contract asks (tensor cores would round the operands to TF32): 256
// threads form a 16 x 16 grid; each thread owns a 4 x 4 block of the 64 x 64
// score tile and 4 rows of the output tile at columns tx*4 + 64*n; operands
// sit in shared memory with their contraction index major, so two 16-byte
// loads feed 16 fused multiply-adds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kMask = -1e30f;
constexpr int kThreads = 256;
constexpr int kTile = 64;        // query rows and key rows of a tile
constexpr int kLdT = kTile + 4;  // row stride of [D][kTile] and [kTile][kTile]

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const float* mask;  // [Bm * Hm][S][S] or null
  void* o;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  int H, Hk, S, Bm, Hm;
  int causal, dropout;
  float scale;
  unsigned thr;     // keep where hash >= thr
  float keep_div;   // 1 - rate, as f32
  unsigned seed;
};

// `_dropout_keep` of the TPU kernel, in uint32 arithmetic.
__device__ __forceinline__ bool keep(const Params& p, unsigned b,
                                     unsigned row, unsigned col) {
  unsigned x = row * 0x9E3779B9u + col * 0x85EBCA6Bu;
  x ^= p.seed + b * 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= p.thr;
}

__device__ __forceinline__ int kv_row(const Params& p, int b) {
  return (b / p.H) * p.Hk + (b % p.H) / (p.H / p.Hk);
}

__device__ __forceinline__ const float* mask_rows(const Params& p, int b) {
  if (p.mask == nullptr) return nullptr;
  const int mb =
      (p.Bm > 1 ? b / p.H : 0) * p.Hm + (p.Hm > 1 ? b % p.H : 0);
  return p.mask + static_cast<long long>(mb) * p.S * p.S;
}

// The score of (row, col) from the raw dot product: scale, mask + clamp,
// causal fill, and -1e30 outside [0, S) (padding of the ragged last tile).
__device__ __forceinline__ float score(const Params& p, const float* mask,
                                       float dot, int row, int col) {
  if (row >= p.S || col >= p.S) return kMask;
  float x = dot * p.scale;
  if (mask != nullptr) {
    x = x + mask[static_cast<long long>(row) * p.S + col];
    x = x < kMask ? kMask : x;
  }
  if (p.causal && col > row) x = kMask;
  return x;
}

// --------------------------------------------------- f32: the CUDA cores

// Rows [r0, r0 + 64) of a [S][D] f32 matrix into a transposed tile t[d][r]
// (stride kLdT). Consecutive threads take consecutive rows, so the shared
// stores do not conflict; rows past S are 0.
template <int D>
__device__ __forceinline__ void load_t(float* t, const float* src, int r0,
                                       int S) {
  const int r = threadIdx.x % kTile;
  for (int c = threadIdx.x / kTile; c < D / 4; c += kThreads / kTile) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      x = *reinterpret_cast<const float4*>(
          src + static_cast<long long>(r0 + r) * D + c * 4);
    t[(c * 4 + 0) * kLdT + r] = x.x;
    t[(c * 4 + 1) * kLdT + r] = x.y;
    t[(c * 4 + 2) * kLdT + r] = x.z;
    t[(c * 4 + 3) * kLdT + r] = x.w;
  }
}

// Rows [r0, r0 + 64) of a [S][D] f32 matrix into a row-major tile t[r][d]
// (stride D + 4); rows past S are 0.
template <int D>
__device__ __forceinline__ void load_r(float* t, const float* src, int r0,
                                       int S) {
  for (int idx = threadIdx.x; idx < kTile * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c = idx % (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      x = *reinterpret_cast<const float4*>(
          src + static_cast<long long>(r0 + r) * D + c * 4);
    *reinterpret_cast<float4*>(t + r * (D + 4) + c * 4) = x;
  }
}

// acc[i][n*4 + j] += sum_k A[k][ty*4 + i] * B[k][n*64 + tx*4 + j]
template <int NB>
__device__ __forceinline__ void mma_acc(float (&acc)[4][4 * NB],
                                        const float* A, int lda,
                                        const float* B, int ldb, int K,
                                        int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(A + kk * lda + ty * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float bv[4 * NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float4 b =
          *reinterpret_cast<const float4*>(B + kk * ldb + n * 64 + tx * 4);
      bv[n * 4 + 0] = b.x;
      bv[n * 4 + 1] = b.y;
      bv[n * 4 + 2] = b.z;
      bv[n * 4 + 3] = b.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NB; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// buf[(tx*4 + j) * kLdT + ty*4 + i] = val[i][j]: a thread's 4 x 4 block,
// transposed, four 16-byte stores.
__device__ __forceinline__ void store_t(float* buf, const float (&val)[4][4],
                                        int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(buf + (tx * 4 + j) * kLdT + ty * 4) =
        make_float4(val[0][j], val[1][j], val[2][j], val[3][j]);
}

// Reductions over the 16 threads of a row (lanes that differ in bits 0-3).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// f32 forward
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * D * kLdT + kTile * (D + 4) + kTile * kLdT);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int NB = D / 64;
  constexpr int LDR = D + 4;
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);  // [D][kLdT]
  float* sKt = sQt + D * kLdT;                   // [D][kLdT]
  float* sV = sKt + D * kLdT;                    // [kTile][LDR]
  float* sPt = sV + kTile * LDR;                 // [kTile keys][kLdT rows]

  const int b = blockIdx.y;
  const int qt = blockIdx.x;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long plane = static_cast<long long>(p.S) * D;
  const float* q = static_cast<const float*>(p.q) + b * plane;
  const float* k = static_cast<const float*>(p.k) + kv_row(p, b) * plane;
  const float* v = static_cast<const float*>(p.v) + kv_row(p, b) * plane;
  const float* mask = mask_rows(p, b);

  load_t<D>(sQt, q, q0, p.S);
  float m[4], l[4], acc[4][4 * NB];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) acc[i][j] = 0.f;
  }

  const int nk = (p.S + kTile - 1) / kTile;
  const int last = p.causal ? qt : nk - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    load_t<D>(sKt, k, k0, p.S);
    load_r<D>(sV, v, k0, p.S);
    __syncthreads();

    float s[4][4] = {};
    mma_acc<1>(s, sQt, kLdT, sKt, kLdT, D, ty, tx);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mc = kMask;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score(p, mask, s[i][j], row, k0 + tx * 4 + j);
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mc));
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float e = expf(s[i][j] - m_new);
        e = s[i][j] <= 0.5f * kMask ? 0.f : e;
        sum += e;
        if (p.dropout)
          e = keep(p, b, row, k0 + tx * 4 + j) ? e / p.keep_div : 0.f;
        s[i][j] = e;
      }
      l[i] = l[i] * alpha[i] + row_sum(sum);
      m[i] = m_new;
    }
    store_t(sPt, s, ty, tx);
    __syncthreads();

    float pv[4][4 * NB] = {};
    mma_acc<NB>(pv, sPt, kLdT, sV, LDR, kTile, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NB; ++j) acc[i][j] = acc[i][j] * alpha[i] + pv[i][j];
    __syncthreads();
  }

  float* o = static_cast<float*>(p.o) + b * plane;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[static_cast<long long>(row) * D + n * 64 + tx * 4 + j] =
            acc[i][n * 4 + j] / l_safe;
    if (tx == 0)
      p.lse[static_cast<long long>(b) * p.S + row] = m[i] + logf(l_safe);
  }
}

// f32 dq
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * D * kLdT + kTile * (D + 4) + kTile * kLdT);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  constexpr int NB = D / 64;
  constexpr int LDR = D + 4;
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);  // [D][kLdT]
  float* sdOt = sQt + D * kLdT;                  // [D][kLdT]
  float* sKt = sdOt + D * kLdT;                  // [D][kLdT]
  float* sVt = sKt + D * kLdT;                   // [D][kLdT]
  float* sK = sVt + D * kLdT;                    // [kTile][LDR]
  float* sdSt = sK + kTile * LDR;                // [kTile keys][kLdT rows]

  const int b = blockIdx.y;
  const int qt = blockIdx.x;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long plane = static_cast<long long>(p.S) * D;
  const float* q = static_cast<const float*>(p.q) + b * plane;
  const float* dout = static_cast<const float*>(p.dout) + b * plane;
  const float* k = static_cast<const float*>(p.k) + kv_row(p, b) * plane;
  const float* v = static_cast<const float*>(p.v) + kv_row(p, b) * plane;
  const float* mask = mask_rows(p, b);

  load_t<D>(sQt, q, q0, p.S);
  load_t<D>(sdOt, dout, q0, p.S);
  float lse[4], delta[4], acc[4][4 * NB];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const long long at = static_cast<long long>(b) * p.S + row;
    lse[i] = row < p.S ? p.lse_in[at] : 0.f;
    delta[i] = row < p.S ? p.delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) acc[i][j] = 0.f;
  }

  const int nk = (p.S + kTile - 1) / kTile;
  const int last = p.causal ? qt : nk - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    load_t<D>(sKt, k, k0, p.S);
    load_t<D>(sVt, v, k0, p.S);
    load_r<D>(sK, k, k0, p.S);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    mma_acc<1>(s, sQt, kLdT, sKt, kLdT, D, ty, tx);
    mma_acc<1>(dp, sdOt, kLdT, sVt, kLdT, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const float x = score(p, mask, s[i][j], row, col);
        float pr = expf(x - lse[i]);
        pr = x <= 0.5f * kMask ? 0.f : pr;
        float d = dp[i][j];
        if (p.dropout) d = keep(p, b, row, col) ? d / p.keep_div : 0.f;
        s[i][j] = pr * (d - delta[i]) * p.scale;
      }
    }
    store_t(sdSt, s, ty, tx);
    __syncthreads();

    mma_acc<NB>(acc, sdSt, kLdT, sK, LDR, kTile, ty, tx);
    __syncthreads();
  }

  float* dq = static_cast<float*>(p.dq) + b * plane;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.S) continue;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dq[static_cast<long long>(row) * D + n * 64 + tx * 4 + j] =
            acc[i][n * 4 + j];
  }
}

// f32 dkv
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (4 * D * kLdT + 2 * kTile * (D + 4) + kTile * kLdT + 2 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Params p) {
  constexpr int NB = D / 64;
  constexpr int LDR = D + 4;
  extern __shared__ float4 smem4[];
  float* sKt = reinterpret_cast<float*>(smem4);  // [D][kLdT]
  float* sVt = sKt + D * kLdT;                   // [D][kLdT]
  float* sQt = sVt + D * kLdT;                   // [D][kLdT]
  float* sdOt = sQt + D * kLdT;                  // [D][kLdT]
  float* sQ = sdOt + D * kLdT;                   // [kTile][LDR]
  float* sdO = sQ + kTile * LDR;                 // [kTile][LDR]
  float* sBuf = sdO + kTile * LDR;               // [kTile rows][kLdT keys]
  float* sLse = sBuf + kTile * kLdT;             // [kTile]
  float* sDelta = sLse + kTile;                  // [kTile]

  const int b = blockIdx.y;
  const int kt = blockIdx.x;
  const int k0 = kt * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long plane = static_cast<long long>(p.S) * D;
  const float* q = static_cast<const float*>(p.q) + b * plane;
  const float* dout = static_cast<const float*>(p.dout) + b * plane;
  const float* k = static_cast<const float*>(p.k) + kv_row(p, b) * plane;
  const float* v = static_cast<const float*>(p.v) + kv_row(p, b) * plane;
  const float* mask = mask_rows(p, b);

  load_t<D>(sKt, k, k0, p.S);
  load_t<D>(sVt, v, k0, p.S);
  float dk[4][4 * NB], dv[4][4 * NB];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nq = (p.S + kTile - 1) / kTile;
  for (int qt = p.causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    load_t<D>(sQt, q, q0, p.S);
    load_t<D>(sdOt, dout, q0, p.S);
    load_r<D>(sQ, q, q0, p.S);
    load_r<D>(sdO, dout, q0, p.S);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const long long at = static_cast<long long>(b) * p.S + row;
      sLse[threadIdx.x] = row < p.S ? p.lse_in[at] : 0.f;
      sDelta[threadIdx.x] = row < p.S ? p.delta[at] : 0.f;
    }
    __syncthreads();

    // transposed tiles: st[i][j] is (key k0 + ty*4 + i, query q0 + tx*4 + j)
    float st[4][4] = {}, dpt[4][4] = {};
    mma_acc<1>(st, sKt, kLdT, sQt, kLdT, D, ty, tx);
    mma_acc<1>(dpt, sVt, kLdT, sdOt, kLdT, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx * 4 + j;
        const float x = score(p, mask, st[i][j], row, col);
        float pr = expf(x - sLse[tx * 4 + j]);
        pr = x <= 0.5f * kMask ? 0.f : pr;
        float pd = pr, d = dpt[i][j];
        if (p.dropout) {
          const bool kp = keep(p, b, row, col);
          pd = kp ? pr / p.keep_div : 0.f;
          d = kp ? d / p.keep_div : 0.f;
        }
        st[i][j] = pd;
        dpt[i][j] = pr * (d - sDelta[tx * 4 + j]) * p.scale;
      }
    }
    store_t(sBuf, st, ty, tx);  // P_drop as [query][key]
    __syncthreads();
    mma_acc<NB>(dv, sBuf, kLdT, sdO, LDR, kTile, ty, tx);
    __syncthreads();
    store_t(sBuf, dpt, ty, tx);  // dS as [query][key]
    __syncthreads();
    mma_acc<NB>(dk, sBuf, kLdT, sQ, LDR, kTile, ty, tx);
    __syncthreads();
  }

  float* dkp = static_cast<float*>(p.dk) + b * plane;
  float* dvp = static_cast<float*>(p.dv) + b * plane;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= p.S) continue;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long at = static_cast<long long>(row) * D + n * 64 +
                             tx * 4 + j;
        dkp[at] = dk[i][n * 4 + j];
        dvp[at] = dv[i][n * 4 + j];
      }
  }
}

using bf16 = __nv_bfloat16;

// Max and sum over the 4 lanes that hold one row of a `wgmma` accumulator
// fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------- bf16 fwd, dQ and dK/dV: wgmma and TMA
// All three kernels run 384 threads: warpgroup 0 is the producer (one warp
// of it issues TMA loads into a ring of shared-memory stages, the other
// three exit) and gives up registers with setmaxnreg; warpgroups 1 and 2
// are the consumers, each owning 64 rows of the block's 128-row tile, and
// take the registers. Stage s has a `full` barrier (the producer's arrivals plus the
// TMA bytes) and an `empty` barrier (one arrival from each of the eight
// consumer warps once their products have read the stage).
namespace hw = hopper;

constexpr int kWgThreads = 384;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hw::smem_u32(p) & 1023)) & 1023);
}

// The forward: a block owns 128 query rows of one (batch*head) and walks
// the 128-key tiles of K and V. Q, K and V tiles are D/64 panels of
// 128 x 64 (hopper.cuh).
template <int D>
struct FwdShape {
  static constexpr int kM = 128;
  static constexpr int kN = 128;
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kKvBytes = kN * D * 2;  // one K or one V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKvBytes;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

template <int D, bool kGeneral>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Params p) {
  using C = FwdShape<D>;
  static_assert(C::kM == C::kN, "one offset serves Q and K panels");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::kStages;

  const int b = blockIdx.x;
  // causal blocks start longest first: the last query tile sees every key
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * C::kM;
  const int nk = (p.S + C::kN - 1) / C::kN;
  const int n_iter = p.causal ? qt + 1 : nk;  // kM == kN: qt < nk

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 8);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer
    hw::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hw::tma_prefetch(&tq);
      hw::tma_prefetch(&tk);
      hw::tma_prefetch(&tv);
      const int kvb = kv_row(p, b);
      hw::mbar_arrive_tx(q_full, C::kQBytes);
      for (int pn = 0; pn < C::kPanels; ++pn)
        hw::tma_load_3d(sQ + pn * C::kM * 128, &tq, q_full, pn * 64, q0, b);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % C::kStages;
        hw::mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
        uint8_t* sK = smem + C::kQBytes + s * 2 * C::kKvBytes;
        uint8_t* sV = sK + C::kKvBytes;
        hw::mbar_arrive_tx(&full[s], 2 * C::kKvBytes);
        for (int pn = 0; pn < C::kPanels; ++pn) {
          hw::tma_load_3d(sK + pn * C::kN * 128, &tk, &full[s], pn * 64,
                          it * C::kN, kvb);
          hw::tma_load_3d(sV + pn * C::kN * 128, &tv, &full[s], pn * 64,
                          it * C::kN, kvb);
        }
      }
    }
  } else {
    // ---- consumers
    hw::regs_alloc<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int wg = threadIdx.x / 128 - 1;
    const int r0 = q0 + 64 * wg;  // the warpgroup's first row
    const float scale_log2 = p.scale * kLog2e;
    float o[C::kPanels][32];
#pragma unroll
    for (int pn = 0; pn < C::kPanels; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[pn][i] = 0.f;
    float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};

    const uint64_t dQ = hw::desc(sQ + wg * 64 * 128);
    hw::mbar_wait(q_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % C::kStages;
      const int k0 = it * C::kN;
      const uint8_t* sK = smem + C::kQBytes + s * 2 * C::kKvBytes;
      const uint8_t* sV = sK + C::kKvBytes;
      hw::mbar_wait(&full[s], (it / C::kStages) & 1);

      // S = Q . K^T, both K-major
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      const uint64_t dK = hw::desc(sK);
      hw::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * C::kM * 128 + (kk % 4) * 32;
        hw::wgmma_ss_n128(sc, dQ + (off >> 4), dK + (off >> 4), 1);
      }
      hw::wg_commit();
      hw::wg_wait<0>();
      hw::fence_regs(sc);

      // Scores in f32. Under a mask or dropout (the kGeneral build) every
      // tile takes the per-element rules of score() and keep(). Otherwise
      // only the diagonal tile and the ragged last tile mask anything, with
      // one compare an element, and every other tile is a plain scaled dot
      // product whose scale folds into the exponent.
      const bool edge = kGeneral || (p.causal && it == n_iter - 1) ||
                        k0 + C::kN > p.S;
      float mx[2] = {kMask, kMask};
      if constexpr (kGeneral) {
        const float* mask = mask_rows(p, b);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          sc[i] = score(p, mask, sc[i], r0 + hw::acc_row(t, i),
                        k0 + hw::acc_col(t, i));
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        }
      } else if (edge) {
        int last[2];  // the last key each of the thread's two rows sees
#pragma unroll
        for (int h = 0; h < 2; ++h)
          last[h] = p.causal ? min(r0 + hw::acc_row(t, 2 * h), p.S - 1)
                             : p.S - 1;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int h = (i >> 1) & 1;
          sc[i] = k0 + hw::acc_col(t, i) <= last[h] ? sc[i] * p.scale : kMask;
          mx[h] = fmaxf(mx[h], sc[i]);
        }
      } else {
        mx[0] = mx[1] = __int_as_float(0xff800000);  // -inf
#pragma unroll
        for (int i = 0; i < 64; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        mx[0] *= p.scale;  // scale > 0: the max of the scaled scores
        mx[1] *= p.scale;
      }
      float alpha[2], ml[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], quad_max(mx[h]));
        alpha[h] = exp2f((m[h] - mn) * kLog2e);
        m[h] = mn;
        ml[h] = mn * kLog2e;
      }
      if (edge) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int h = (i >> 1) & 1;
          const float x = sc[i];
          float e = exp2f(fmaf(x, kLog2e, -ml[h]));
          e = x <= 0.5f * kMask ? 0.f : e;
          sum[h] += e;
          if constexpr (kGeneral) {
            if (p.dropout)
              e = keep(p, b, r0 + hw::acc_row(t, i), k0 + hw::acc_col(t, i))
                      ? e / p.keep_div
                      : 0.f;
          }
          sc[i] = e;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int h = (i >> 1) & 1;
          const float e = exp2f(fmaf(sc[i], scale_log2, -ml[h]));
          sum[h] += e;
          sc[i] = e;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
#pragma unroll
      for (int pn = 0; pn < C::kPanels; ++pn)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[pn][i] *= alpha[(i >> 1) & 1];

      // O += P . V: P rounded to bf16 in registers, V read as it lies
      // ([key][d], MN-major) through the transpose flag
      uint32_t pa[C::kN / 16][4];
      hw::acc_to_a<C::kN>(pa, sc);
      const uint64_t dV = hw::desc(sV);
      hw::wg_fence();
#pragma unroll
      for (int pn = 0; pn < C::kPanels; ++pn)
#pragma unroll
        for (int j = 0; j < C::kN / 16; ++j)
          hw::wgmma_rs_n64_tb(o[pn], pa[j],
                              dV + ((pn * C::kN * 128 + j * 2048) >> 4));
      hw::wg_commit();
      hw::wg_wait<0>();
#pragma unroll
      for (int pn = 0; pn < C::kPanels; ++pn) hw::fence_regs(o[pn]);
      if ((t & 31) == 0) hw::mbar_arrive(&empty[s]);
    }

    float l_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_safe[h] = l[h] == 0.f ? 1.f : l[h];
      const int row = r0 + hw::acc_row(t, 2 * h);
      if (row < p.S && (t & 3) == 0)
        p.lse[static_cast<long long>(b) * p.S + row] = m[h] + logf(l_safe[h]);
    }
    bf16* out = static_cast<bf16*>(p.o) + static_cast<long long>(b) * p.S * D;
#pragma unroll
    for (int pn = 0; pn < C::kPanels; ++pn)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        const int row = r0 + hw::acc_row(t, i);
        if (row < p.S)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<long long>(row) * D + pn * 64 +
              hw::acc_col(t, i)) =
              __floats2bfloat162_rn(o[pn][i] / l_safe[h],
                                    o[pn][i + 1] / l_safe[h]);
      }
  }
}

// dK/dV: a block owns 128 keys of one (batch*head), keeps their K and V
// tiles resident, and streams 64-row tiles of Q and dO (with their lse and
// delta rows) through the ring. The transposed score tiles S^T = K . Q^T
// and dP^T = V . dO^T are key-major accumulator fragments, so once rounded
// to bf16 they are the register A operands of dV += P_drop^T . dO and
// dK += dS^T . Q, whose B (dO, Q) is read as it lies through the
// transpose flag.
template <int D>
struct DkvShape {
  static constexpr int kN = 128;  // keys of the block
  static constexpr int kM = 64;   // query rows of a streamed tile
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = 3;
  static constexpr int kKvBytes = kN * D * 2;  // one K or one V tile
  static constexpr int kQBytes = kM * D * 2;   // one Q or one dO tile
  static constexpr int kRowsOffset = 2 * kKvBytes + kStages * 2 * kQBytes;
  static constexpr int kBarOffset = kRowsOffset + kStages * 2 * kM * 4;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

template <int D, bool kGeneral>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const Params p) {
  using C = DkvShape<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sK = smem;
  uint8_t* sV = smem + C::kKvBytes;
  float* rows = reinterpret_cast<float*>(smem + C::kRowsOffset);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::kStages;

  const int b = blockIdx.x;
  const int k0 = blockIdx.y * C::kN;
  const int nq = (p.S + C::kM - 1) / C::kM;
  const int q_first = p.causal ? k0 / C::kM : 0;  // the diagonal tile
  const int n_iter = nq - q_first;

  if (threadIdx.x == 0) {
    hw::mbar_init(kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      hw::mbar_init(&full[s], 32);
      hw::mbar_init(&empty[s], 8);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: lane 0 issues the TMA loads, the warp copies lse and
    // delta rows, and every lane arrives on the stage's full barrier
    hw::regs_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hw::tma_prefetch(&tq);
        hw::tma_prefetch(&tdo);
        const int kvb = kv_row(p, b);
        hw::mbar_arrive_tx(kv_full, 2 * C::kKvBytes);
        for (int pn = 0; pn < C::kPanels; ++pn) {
          hw::tma_load_3d(sK + pn * C::kN * 128, &tk, kv_full, pn * 64, k0,
                          kvb);
          hw::tma_load_3d(sV + pn * C::kN * 128, &tv, kv_full, pn * 64, k0,
                          kvb);
        }
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % C::kStages;
        const int q0 = (q_first + it) * C::kM;
        hw::mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
        float* sl = rows + s * 2 * C::kM;
        for (int r = lane; r < C::kM; r += 32) {
          const long long at = static_cast<long long>(b) * p.S + q0 + r;
          const bool in = q0 + r < p.S;
          sl[r] = in ? p.lse_in[at] : 0.f;
          sl[C::kM + r] = in ? p.delta[at] : 0.f;
        }
        if (lane == 0) {
          uint8_t* sQ = smem + 2 * C::kKvBytes + s * 2 * C::kQBytes;
          uint8_t* sdO = sQ + C::kQBytes;
          hw::mbar_arrive_tx(&full[s], 2 * C::kQBytes);
          for (int pn = 0; pn < C::kPanels; ++pn) {
            hw::tma_load_3d(sQ + pn * C::kM * 128, &tq, &full[s], pn * 64, q0,
                            b);
            hw::tma_load_3d(sdO + pn * C::kM * 128, &tdo, &full[s], pn * 64,
                            q0, b);
          }
        } else {
          hw::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumers
    hw::regs_alloc<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int wg = threadIdx.x / 128 - 1;
    const int kw = k0 + 64 * wg;  // the warpgroup's first key
    const float scale_log2 = p.scale * kLog2e;
    float dk[C::kPanels][32], dv[C::kPanels][32];
#pragma unroll
    for (int pn = 0; pn < C::kPanels; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[pn][i] = dv[pn][i] = 0.f;

    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    // this warpgroup's 64 keys of K and V
    const uint64_t dK = hw::desc(sK + wg * 64 * 128);
    const uint64_t dV = hw::desc(sV + wg * 64 * 128);
    hw::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % C::kStages;
      const int q0 = (q_first + it) * C::kM;
      const uint8_t* sQ = smem + 2 * C::kKvBytes + s * 2 * C::kQBytes;
      const uint8_t* sdO = sQ + C::kQBytes;
      const float* sl = rows + s * 2 * C::kM;
      hw::mbar_wait(&full[s], (it / C::kStages) & 1);

      // S^T = K . Q^T and dP^T = V . dO^T, all K-major
      const uint64_t dQ = hw::desc(sQ), ddO = hw::desc(sdO);
      hw::fence_regs(st);
      hw::fence_regs(dpt);
      hw::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int pn = kk / 4, ko = (kk % 4) * 32;  // panel, k slice
        const int kv_off = (pn * C::kN * 128 + ko) >> 4;
        const int q_off = (pn * C::kM * 128 + ko) >> 4;
        hw::wgmma_ss_n64(st, dK + kv_off, dQ + q_off, kk > 0);
        hw::wgmma_ss_n64(dpt, dV + kv_off, ddO + q_off, kk > 0);
      }
      hw::wg_commit();
      hw::wg_wait<0>();
      hw::fence_regs(st);
      hw::fence_regs(dpt);

      // As in the forward: the kGeneral build (mask or dropout) takes the
      // per-element rules on every tile; otherwise only tiles that cross
      // the diagonal or S mask anything, with compares, and the others
      // fold the scale into the exponent.
      const bool edge = kGeneral || (p.causal && q0 < kw + 64) ||
                        q0 + C::kM > p.S || kw + 64 > p.S;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int qc = 8 * c + 2 * (t & 3);  // this chunk's two queries
        const float2 lse2 = *reinterpret_cast<const float2*>(sl + qc);
        const float2 del2 = *reinterpret_cast<const float2*>(sl + C::kM + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e;
          const float lse = (e & 1) ? lse2.y : lse2.x;
          const float delta = (e & 1) ? del2.y : del2.x;
          const int row = q0 + qc + (e & 1);       // query
          const int col = kw + hw::acc_row(t, i);  // key
          float pr, pd, d = dpt[i];
          if constexpr (kGeneral) {
            const float x = score(p, mask_rows(p, b), st[i], row, col);
            pr = exp2f(fmaf(x, kLog2e, -lse * kLog2e));
            pr = x <= 0.5f * kMask ? 0.f : pr;
            pd = pr;
            if (p.dropout) {
              const bool kp = keep(p, b, row, col);
              pd = kp ? pr / p.keep_div : 0.f;
              d = kp ? d / p.keep_div : 0.f;
            }
          } else {
            pr = exp2f(fmaf(st[i], scale_log2, -lse * kLog2e));
            if (edge) {
              const bool seen = row < p.S && col < p.S &&
                                !(p.causal && col > row);
              pr = seen ? pr : 0.f;
            }
            pd = pr;
          }
          st[i] = pd;
          dpt[i] = pr * (d - delta) * p.scale;
        }
      }

      // dV += P_drop^T . dO and dK += dS^T . Q, B read as it lies
      uint32_t pa[C::kM / 16][4], dsa[C::kM / 16][4];
      hw::acc_to_a<C::kM>(pa, st);
      hw::acc_to_a<C::kM>(dsa, dpt);
      hw::fence_regs(pa);
      hw::fence_regs(dsa);
#pragma unroll
      for (int pn = 0; pn < C::kPanels; ++pn) {
        hw::fence_regs(dk[pn]);
        hw::fence_regs(dv[pn]);
      }
      hw::wg_fence();
#pragma unroll
      for (int pn = 0; pn < C::kPanels; ++pn)
#pragma unroll
        for (int j = 0; j < C::kM / 16; ++j) {
          const int off = (pn * C::kM * 128 + j * 2048) >> 4;
          hw::wgmma_rs_n64_tb(dv[pn], pa[j], ddO + off);
          hw::wgmma_rs_n64_tb(dk[pn], dsa[j], dQ + off);
        }
      hw::wg_commit();
      hw::wg_wait<0>();
#pragma unroll
      for (int pn = 0; pn < C::kPanels; ++pn) {
        hw::fence_regs(dk[pn]);
        hw::fence_regs(dv[pn]);
      }
      if ((t & 31) == 0) hw::mbar_arrive(&empty[s]);
    }

    const long long plane = static_cast<long long>(p.S) * D;
    bf16* dkp = static_cast<bf16*>(p.dk) + b * plane;
    bf16* dvp = static_cast<bf16*>(p.dv) + b * plane;
#pragma unroll
    for (int pn = 0; pn < C::kPanels; ++pn)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = kw + hw::acc_row(t, i);
        if (row >= p.S) continue;
        const long long at =
            static_cast<long long>(row) * D + pn * 64 + hw::acc_col(t, i);
        *reinterpret_cast<__nv_bfloat162*>(dkp + at) =
            __floats2bfloat162_rn(dk[pn][i], dk[pn][i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvp + at) =
            __floats2bfloat162_rn(dv[pn][i], dv[pn][i + 1]);
      }
  }
}

// dQ: a block owns 128 query rows of one (batch*head), keeps their Q and
// dO tiles resident (lse and delta sit in the consumers' registers), and
// streams 64-key tiles of K and V through the ring. S = Q . K^T and
// dP = dO . V^T are query-major accumulator fragments, so dS, rounded to
// bf16, is the register A operand of dQ += dS . K, whose B (K) is read as
// it lies through the transpose flag.
template <int D>
struct DqShape {
  static constexpr int kM = 128;  // query rows of the block
  static constexpr int kN = 64;   // keys of a streamed tile
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = 4;
  static constexpr int kQBytes = kM * D * 2;   // one Q or one dO tile
  static constexpr int kKvBytes = kN * D * 2;  // one K or one V tile
  static constexpr int kBarOffset = 2 * kQBytes + kStages * 2 * kKvBytes;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

template <int D, bool kGeneral>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const Params p) {
  using C = DqShape<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sdO = smem + C::kQBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::kStages;

  const int b = blockIdx.x;
  // causal blocks start longest first: the last query tile sees every key
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * C::kM;
  const int nk = (p.S + C::kN - 1) / C::kN;
  // causal: up to the tile that holds the block's last diagonal element
  const int n_iter = p.causal ? min(nk, (q0 + C::kM) / C::kN) : nk;

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 8);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer
    hw::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hw::tma_prefetch(&tq);
      hw::tma_prefetch(&tdo);
      hw::tma_prefetch(&tk);
      hw::tma_prefetch(&tv);
      const int kvb = kv_row(p, b);
      hw::mbar_arrive_tx(q_full, 2 * C::kQBytes);
      for (int pn = 0; pn < C::kPanels; ++pn) {
        hw::tma_load_3d(sQ + pn * C::kM * 128, &tq, q_full, pn * 64, q0, b);
        hw::tma_load_3d(sdO + pn * C::kM * 128, &tdo, q_full, pn * 64, q0,
                        b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % C::kStages;
        hw::mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
        uint8_t* sK = smem + 2 * C::kQBytes + s * 2 * C::kKvBytes;
        uint8_t* sV = sK + C::kKvBytes;
        hw::mbar_arrive_tx(&full[s], 2 * C::kKvBytes);
        for (int pn = 0; pn < C::kPanels; ++pn) {
          hw::tma_load_3d(sK + pn * C::kN * 128, &tk, &full[s], pn * 64,
                          it * C::kN, kvb);
          hw::tma_load_3d(sV + pn * C::kN * 128, &tv, &full[s], pn * 64,
                          it * C::kN, kvb);
        }
      }
    }
  } else {
    // ---- consumers
    hw::regs_alloc<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int wg = threadIdx.x / 128 - 1;
    const int r0 = q0 + 64 * wg;  // the warpgroup's first row
    const float scale_log2 = p.scale * kLog2e;
    const float* mask = mask_rows(p, b);
    // the last key tile the warpgroup's rows see; rows past S see none
    const int last = r0 >= p.S ? -1 : p.causal ? r0 / C::kN : nk - 1;
    float lse2[2], delta[2];  // lse * log2(e) and delta of the two rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + hw::acc_row(t, 2 * h);
      const long long at = static_cast<long long>(b) * p.S + row;
      lse2[h] = row < p.S ? p.lse_in[at] * kLog2e : 0.f;
      delta[h] = row < p.S ? p.delta[at] : 0.f;
    }
    float dq[C::kPanels][32];
#pragma unroll
    for (int pn = 0; pn < C::kPanels; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[pn][i] = 0.f;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;

    // this warpgroup's 64 rows of Q and dO
    const uint64_t dQ = hw::desc(sQ + wg * 64 * 128);
    const uint64_t ddO = hw::desc(sdO + wg * 64 * 128);
    hw::mbar_wait(q_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % C::kStages;
      const int k0 = it * C::kN;
      const uint8_t* sK = smem + 2 * C::kQBytes + s * 2 * C::kKvBytes;
      const uint8_t* sV = sK + C::kKvBytes;
      // wait even for a tile this warpgroup skips: its arrival on the
      // empty barrier must not run ahead of the other warpgroup's
      hw::mbar_wait(&full[s], (it / C::kStages) & 1);
      if (it <= last) {
        // S = Q . K^T and dP = dO . V^T, all K-major
        const uint64_t dK = hw::desc(sK), dV = hw::desc(sV);
        hw::fence_regs(sc);
        hw::fence_regs(dp);
        hw::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int pn = kk / 4, ko = (kk % 4) * 32;  // panel, k slice
          const int q_off = (pn * C::kM * 128 + ko) >> 4;
          const int kv_off = (pn * C::kN * 128 + ko) >> 4;
          hw::wgmma_ss_n64(sc, dQ + q_off, dK + kv_off, kk > 0);
          hw::wgmma_ss_n64(dp, ddO + q_off, dV + kv_off, kk > 0);
        }
        hw::wg_commit();
        hw::wg_wait<0>();
        hw::fence_regs(sc);
        hw::fence_regs(dp);

        // dS = P * (dP_drop - delta) * scale. As in the other kernels: the
        // kGeneral build (mask or dropout) takes the per-element rules on
        // every tile; otherwise only the diagonal tile and tiles past S
        // mask anything, and the others fold the scale into the exponent.
        const bool edge = kGeneral || (p.causal && k0 + C::kN > r0) ||
                          k0 + C::kN > p.S || r0 + 64 > p.S;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          const int row = r0 + hw::acc_row(t, i);
          const int col = k0 + hw::acc_col(t, i);
          float pr, d = dp[i];
          if constexpr (kGeneral) {
            const float x = score(p, mask, sc[i], row, col);
            pr = exp2f(fmaf(x, kLog2e, -lse2[h]));
            pr = x <= 0.5f * kMask ? 0.f : pr;
            if (p.dropout) d = keep(p, b, row, col) ? d / p.keep_div : 0.f;
          } else {
            pr = exp2f(fmaf(sc[i], scale_log2, -lse2[h]));
            if (edge) {
              const bool seen = row < p.S && col < p.S &&
                                !(p.causal && col > row);
              pr = seen ? pr : 0.f;
            }
          }
          sc[i] = pr * (d - delta[h]) * p.scale;
        }

        // dQ += dS . K, K read as it lies ([key][d], MN-major)
        uint32_t dsa[C::kN / 16][4];
        hw::acc_to_a<C::kN>(dsa, sc);
        hw::fence_regs(dsa);
#pragma unroll
        for (int pn = 0; pn < C::kPanels; ++pn) hw::fence_regs(dq[pn]);
        hw::wg_fence();
#pragma unroll
        for (int pn = 0; pn < C::kPanels; ++pn)
#pragma unroll
          for (int j = 0; j < C::kN / 16; ++j)
            hw::wgmma_rs_n64_tb(dq[pn], dsa[j],
                                dK + ((pn * C::kN * 128 + j * 2048) >> 4));
        hw::wg_commit();
        hw::wg_wait<0>();
#pragma unroll
        for (int pn = 0; pn < C::kPanels; ++pn) hw::fence_regs(dq[pn]);
      }
      if ((t & 31) == 0) hw::mbar_arrive(&empty[s]);
    }

    bf16* out = static_cast<bf16*>(p.dq) + static_cast<long long>(b) * p.S * D;
#pragma unroll
    for (int pn = 0; pn < C::kPanels; ++pn)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = r0 + hw::acc_row(t, i);
        if (row < p.S)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<long long>(row) * D + pn * 64 +
              hw::acc_col(t, i)) =
              __floats2bfloat162_rn(dq[pn][i], dq[pn][i + 1]);
      }
  }
}
// ------------------------------------------------------------------ launch
template <typename Kern>
cudaError_t launch(Kern kern, size_t smem, int threads, int tiles, int BH,
                   const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(tiles, BH), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

enum Which { kFwd, kDq, kDkv };

// f32 inputs: the CUDA-core kernels
template <int D>
cudaError_t run_f32(Which which, int BH, const Params& p, cudaStream_t st) {
  const int tiles = (p.S + kTile - 1) / kTile;
  switch (which) {
    case kFwd:
      return launch(flash_fwd_kernel<D>, fwd_smem<D>(), kThreads,
                    tiles, BH, p, st);
    case kDq:
      return launch(flash_dq_kernel<D>, dq_smem<D>(), kThreads, tiles,
                    BH, p, st);
    case kDkv:
      return launch(flash_dkv_kernel<D>, dkv_smem<D>(), kThreads,
                    tiles, BH, p, st);
  }
  return cudaErrorInvalidValue;
}

// Sets a wgmma kernel's dynamic shared memory and launches it on a
// (BH, tiles) grid: blockIdx.x is the (batch*head), blockIdx.y the tile.
template <typename Kern, typename... Maps>
cudaError_t launch_wgmma(Kern kern, size_t smem, int BH, int tiles,
                         const Params& p, cudaStream_t st,
                         const Maps&... maps) {
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(BH, tiles), kWgThreads, smem, st>>>(maps..., p);
  return cudaGetLastError();
}

// bf16 forward, dQ and dK/dV. They read their tiles through tensor maps
// over [rows][S][D], so a box past S reads zeros, never the next row's
// data. Q and dO boxes are the kernel's kM rows, K and V boxes its kN.
template <int D, bool kGeneral>
cudaError_t run_wgmma(Which which, int BH, const Params& p, cudaStream_t st) {
  if (hw::encode_tiled() == nullptr) return cudaErrorNotSupported;
  const int kv_rows = BH / p.H * p.Hk;
  const int m = which == kFwd  ? FwdShape<D>::kM
                : which == kDq ? DqShape<D>::kM
                               : DkvShape<D>::kM;
  const int n = which == kFwd  ? FwdShape<D>::kN
                : which == kDq ? DqShape<D>::kN
                               : DkvShape<D>::kN;
  CUtensorMap tq, tk, tv, tdo;
  if (!hw::make_map_bf16(&tq, p.q, BH, p.S, D, m) ||
      !hw::make_map_bf16(&tk, p.k, kv_rows, p.S, D, n) ||
      !hw::make_map_bf16(&tv, p.v, kv_rows, p.S, D, n) ||
      (which != kFwd && !hw::make_map_bf16(&tdo, p.dout, BH, p.S, D, m)))
    return cudaErrorInvalidValue;
  switch (which) {
    case kFwd:
      return launch_wgmma(flash_fwd_wgmma_kernel<D, kGeneral>,
                          FwdShape<D>::kSmem, BH, (p.S + m - 1) / m, p, st,
                          tq, tk, tv);
    case kDq:
      return launch_wgmma(flash_dq_wgmma_kernel<D, kGeneral>,
                          DqShape<D>::kSmem, BH, (p.S + m - 1) / m, p, st,
                          tq, tk, tv, tdo);
    case kDkv:
      return launch_wgmma(flash_dkv_wgmma_kernel<D, kGeneral>,
                          DkvShape<D>::kSmem, BH, (p.S + n - 1) / n, p, st,
                          tq, tk, tv, tdo);
  }
  return cudaErrorInvalidValue;
}

// bf16 inputs: the tensor-core kernels. A mask or dropout selects the
// build that carries the per-element rules.
template <int D>
cudaError_t run_bf16(Which which, int BH, const Params& p, cudaStream_t st) {
  if (p.mask != nullptr || p.dropout)
    return run_wgmma<D, true>(which, BH, p, st);
  return run_wgmma<D, false>(which, BH, p, st);
}

cudaError_t dispatch(Which which, int BH, int D, int dtype, const Params& p,
                     cudaStream_t st) {
  if (BH <= 0 || p.S <= 0 || BH > 65535 || p.Hk <= 0 || p.H % p.Hk)
    return cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) return run_f32<64>(which, BH, p, st);
  if (dtype == 0 && D == 128) return run_f32<128>(which, BH, p, st);
  if (dtype == 1 && D == 64) return run_bf16<64>(which, BH, p, st);
  if (dtype == 1 && D == 128) return run_bf16<128>(which, BH, p, st);
  return cudaErrorInvalidValue;
}

Params make_params(int H, int Hk, int S, int Bm, int Hm, float scale,
                   int flags, unsigned thr, float keep_div, unsigned seed) {
  Params p = {};
  p.H = H;
  p.Hk = Hk;
  p.S = S;
  p.Bm = Bm;
  p.Hm = Hm;
  p.causal = flags & 1;
  p.dropout = (flags >> 1) & 1;
  p.scale = scale;
  p.thr = thr;
  p.keep_div = keep_div;
  p.seed = seed;
  return p;
}

}  // namespace

// Tensors are contiguous and 16-byte aligned: q, dO, O, dQ, dK, dV
// [BH][S][D]; k, v [BH / H * Hk][S][D]; lse, delta [BH][S] f32; mask
// [Bm * Hm][S][S] f32 or null. flags: bit 0 causal, bit 1 dropout. dtype:
// 0 = f32 (CUDA cores), 1 = bf16 (tensor cores). Head dims 64 and 128. Each
// returns cudaGetLastError() after its launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* mask, void* o,
                                   void* lse, int BH, int H, int Hk, int S,
                                   int D, int Bm, int Hm, float scale,
                                   int flags, unsigned thr, float keep_div,
                                   unsigned seed, int dtype, void* stream) {
  Params p = make_params(H, Hk, S, Bm, Hm, scale, flags, thr, keep_div, seed);
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const float*>(mask);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  return dispatch(kFwd, BH, D, dtype, p, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* mask,
                                  void* dq, int BH, int H, int Hk, int S,
                                  int D, int Bm, int Hm, float scale,
                                  int flags, unsigned thr, float keep_div,
                                  unsigned seed, int dtype, void* stream) {
  Params p = make_params(H, Hk, S, Bm, Hm, scale, flags, thr, keep_div, seed);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.mask = static_cast<const float*>(mask);
  p.dq = dq;
  return dispatch(kDq, BH, D, dtype, p, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* mask, void* dk, void* dv,
                                   int BH, int H, int Hk, int S, int D,
                                   int Bm, int Hm, float scale, int flags,
                                   unsigned thr, float keep_div,
                                   unsigned seed, int dtype, void* stream) {
  Params p = make_params(H, Hk, S, Bm, Hm, scale, flags, thr, keep_div, seed);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.mask = static_cast<const float*>(mask);
  p.dk = dk;
  p.dv = dv;
  return dispatch(kDkv, BH, D, dtype, p, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the bf16 forward (which = 0), dQ (which = 1)
// and dK/dV (which = 2) kernels at head dim D, in bytes (0 for anything
// else).
extern "C" int flash_attention_wgmma_smem(int which, int D) {
  if (which == kFwd && D == 64) return FwdShape<64>::kSmem;
  if (which == kFwd && D == 128) return FwdShape<128>::kSmem;
  if (which == kDq && D == 64) return DqShape<64>::kSmem;
  if (which == kDq && D == 128) return DqShape<128>::kSmem;
  if (which == kDkv && D == 64) return DkvShape<64>::kSmem;
  if (which == kDkv && D == 128) return DkvShape<128>::kSmem;
  return 0;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
