// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV, each a
// hand-written kernel behind a plain C entry point (ops/flash_attention.py
// binds them with ctypes).
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py (each in an f32 build and a bf16
// `_tc_` build, e.g. flash_fwd_kernel / flash_fwd_tc_kernel):
//   * flash_fwd_kernel  <- `_fwd_kernel` (launched by `_mha_forward`):
//     online-softmax forward, writes O and a per-row logsumexp;
//   * flash_dq_kernel   <- `_dq_kernel` (launched by `_mha_backward`):
//     recomputes P from the logsumexp, dS = P * (dP - delta) * scale,
//     dQ = dS . K;
//   * flash_dkv_kernel  <- `_dkv_kernel` (launched by `_mha_backward`):
//     dV = P_drop^T . dO and dK = dS^T . Q, per query head.
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
// Design. The Pallas grid walks (batch*head, q-block, k-block) in order on
// one core and carries the softmax state in scratch from one k-block to the
// next. Here blocks run in parallel in no order, so each thread block owns
// one (batch*head, 64-row tile) and loops over the other axis itself:
//   * fwd and dq: one block per (b, q-tile), looping over k-tiles, and on
//     causal runs stopping at the tile that holds the diagonal;
//   * dkv: one block per (b, k-tile), looping over q-tiles, and on causal
//     runs starting at the diagonal tile.
// The backward kernels are separate and use no atomics, so their results
// repeat bit for bit from run to run. S may be any length: rows and columns
// past S load as zeros and score as masked. Each kernel comes in two
// builds, by input type:
//   * bf16 (the training path): the products run on the tensor cores
//     (`mma.sync` m16n8k16, bf16 operands, f32 accumulators), four warps a
//     tile (see "bf16: the tensor cores" below);
//   * f32: the products run on the CUDA cores in full f32, which is what
//     the f32 contract asks (tensor cores would round the operands to
//     TF32). 256 threads form a 16 x 16 grid; each thread owns a 4 x 4 block
//     of the 64 x 64 score tile and 4 rows of the output tile at columns
//     tx*4 + 64*n. Every operand sits in shared memory in f32 with its
//     contraction index as the major dimension (transposed where needed),
//     so two 16-byte loads feed 16 fused multiply-adds; row statistics
//     reduce across the 16 threads of a row with warp shuffles.
//
// Bound on this card. At the GPT-350M training shape (head_dim 64,
// S = 1024, bf16, causal) attention does 4 * D flops per (query, key) pair
// in the forward, 6 * D in dq and 8 * D in dkv, against 4 * D bytes a row:
// the forward sits at the card's flop:byte balance and the backward above
// it, so at the 989 TFLOP/s bf16 rate the bound is a few hundredths of a
// millisecond either way. What holds these kernels far above it is
// latency, not bytes or flops: tiles are loaded by all threads and then
// computed, with a barrier between (no cp.async/TMA pipeline), `mma.sync`
// reaches a fraction of the `wgmma` rate, and the softmax runs between the
// two products of every tile. Moving to `wgmma` with TMA-fed, double-
// buffered tiles, and fusing dQ into the dK/dV pass with atomics, is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------ bf16: the tensor cores
// bf16 inputs run their products on the tensor cores: `mma.sync` m16n8k16
// with bf16 operands and f32 accumulators. A block of four warps owns a
// 64-row tile, each warp 16 rows of the result. Operand tiles sit in shared
// memory as bf16, each row padded by 8 elements so the fragment loads of a
// warp hit 32 different banks; the operand whose contraction index is its
// row index is stored transposed. The f32 result tile of the first product
// (scores) is rounded to bf16 in registers and is, in place, the A operand of
// the second (P.V, dS.K, P^T.dO, dS^T.Q), as in FlashAttention-2. Rounding
// P and dS to bf16 there is the TPU kernels' own rounding.
constexpr int kTcThreads = 128;
constexpr int kPadH = 8;  // bf16 elements of padding per shared row

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16, row-major) of X[row][k]: rows r0.., columns k0..
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* X,
                                       int ld, int r0, int k0, int lane) {
  const bf16* x = X + (r0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  a[0] = ld32(x);
  a[1] = ld32(x + 8 * ld);
  a[2] = ld32(x + 8);
  a[3] = ld32(x + 8 * ld + 8);
}

// B fragment (16 x 8, column-major) of an operand stored as Y[n][k]
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* Y, int ld, int n0, int k0,
                                       int lane) {
  const bf16* y = Y + (n0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  b0 = ld32(y);
  b1 = ld32(y + 8);
}

// acc[nt] += X[r0 .. r0+16][0 .. K] . Y[nt*8 .. nt*8+8][0 .. K]^T
template <int NT, int K>
__device__ __forceinline__ void mma_smem(float (&acc)[NT][4], const bf16* X,
                                         int ldx, int r0, const bf16* Y,
                                         int ldy, int lane) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[4];
    frag_a(a, X, ldx, r0, kk, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      frag_b(b0, b1, Y, ldy, nt * 8, kk, lane);
      mma16816(acc[nt], a, b0, b1);
    }
  }
}

// acc[nt] += A . Y[nt*8 .. nt*8+8][0 .. 64]^T with A (16 x 64) in registers
template <int NT>
__device__ __forceinline__ void mma_regs(float (&acc)[NT][4],
                                         const uint32_t (&a)[4][4],
                                         const bf16* Y, int ldy, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      frag_b(b0, b1, Y, ldy, nt * 8, j * 16, lane);
      mma16816(acc[nt], a[j], b0, b1);
    }
}

// A 16 x 64 f32 result tile (8 C fragments), rounded to bf16, as the four A
// fragments of a product over its 64 columns.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&s)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack2(s[2 * j][0], s[2 * j][1]);
    a[j][1] = pack2(s[2 * j][2], s[2 * j][3]);
    a[j][2] = pack2(s[2 * j + 1][0], s[2 * j + 1][1]);
    a[j][3] = pack2(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
}

// Rows [r0, r0 + 64) of a [S][D] bf16 matrix into X[r][d] (stride D + 8),
// or transposed into Xt[d][r] (stride 64 + 8); rows past S are 0.
template <int D>
__device__ __forceinline__ void tc_load(bf16* X, const bf16* src, int r0,
                                        int S) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < kTile * CH; i += kTcThreads) {
    const int r = i / CH, c = i % CH;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(r0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(X + r * (D + kPadH) + c * 8) = v;
  }
}

template <int D>
__device__ __forceinline__ void tc_load_t(bf16* Xt, const bf16* src, int r0,
                                          int S) {
  constexpr int CH = D / 8;
  const int r = threadIdx.x % kTile;
  for (int c = threadIdx.x / kTile; c < CH; c += kTcThreads / kTile) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(r0 + r) * D + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) Xt[(c * 8 + i) * (kTile + kPadH) + r] = e[i];
  }
}

// Max and sum over the 4 lanes that hold one row of a C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Element e of C fragment nt: its row (0..15 within the warp's 16) and
// column (0..8*NT) offsets.
__device__ __forceinline__ int frag_row(int lane, int e) {
  return (lane >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int lane, int nt, int e) {
  return nt * 8 + (lane & 3) * 2 + (e & 1);
}

template <int NT>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[NT][4],
                                           int row0, int lane, int S, int D,
                                           const float (&div)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + (lane >> 2) + h * 8;
    if (row >= S) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<long long>(row) * D + nt * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(acc[nt][2 * h] / div[h],
                                acc[nt][2 * h + 1] / div[h]);
  }
}

template <int D>
constexpr size_t tc_fwd_smem() {
  return sizeof(bf16) * (2 * kTile * (D + kPadH) + D * (kTile + kPadH));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(Params p) {
  constexpr int LD = D + kPadH, LDT = kTile + kPadH, NT = D / 8;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);  // [kTile][LD]
  bf16* sK = sQ + kTile * LD;                 // [kTile][LD]
  bf16* sVt = sK + kTile * LD;                // [D][LDT]

  const int b = blockIdx.y;
  const int qt = blockIdx.x;
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's rows in the tile
  const long long plane = static_cast<long long>(p.S) * D;
  const bf16* q = static_cast<const bf16*>(p.q) + b * plane;
  const bf16* k = static_cast<const bf16*>(p.k) + kv_row(p, b) * plane;
  const bf16* v = static_cast<const bf16*>(p.v) + kv_row(p, b) * plane;
  const float* mask = mask_rows(p, b);

  tc_load<D>(sQ, q, q0, p.S);
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f}, acc[NT][4] = {};
  const int nk = (p.S + kTile - 1) / kTile;
  const int last = p.causal ? qt : nk - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K and V
    tc_load<D>(sK, k, k0, p.S);
    tc_load_t<D>(sVt, v, k0, p.S);
    __syncthreads();

    float s[8][4] = {};
    mma_smem<8, D>(s, sQ, LD, r0, sK, LD, lane);
    float mc[2] = {kMask, kMask};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = score(p, mask, s[nt][e], q0 + r0 + frag_row(lane, e),
                         k0 + frag_col(lane, nt, e));
        mc[e >> 1] = fmaxf(mc[e >> 1], s[nt][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mc[h]));
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        float ev = expf(x - m[e >> 1]);
        ev = x <= 0.5f * kMask ? 0.f : ev;
        sum[e >> 1] += ev;
        if (p.dropout)
          ev = keep(p, b, q0 + r0 + frag_row(lane, e),
                    k0 + frag_col(lane, nt, e))
                   ? ev / p.keep_div
                   : 0.f;
        s[nt][e] = ev;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
    uint32_t pa[4][4];
    pack_a(pa, s);
    mma_regs<NT>(acc, pa, sVt, LDT, lane);
  }

  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_safe[h] = l[h] == 0.f ? 1.f : l[h];
    const int row = q0 + r0 + (lane >> 2) + h * 8;
    if (row < p.S && (lane & 3) == 0)
      p.lse[static_cast<long long>(b) * p.S + row] = m[h] + logf(l_safe[h]);
  }
  store_rows<NT>(static_cast<bf16*>(p.o) + b * plane, acc, q0 + r0, lane,
                 p.S, D, l_safe);
}

template <int D>
constexpr size_t tc_dq_smem() {
  return sizeof(bf16) * (4 * kTile * (D + kPadH) + D * (kTile + kPadH));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_dq_tc_kernel(Params p) {
  constexpr int LD = D + kPadH, LDT = kTile + kPadH, NT = D / 8;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);  // [kTile][LD]
  bf16* sdO = sQ + kTile * LD;                // [kTile][LD]
  bf16* sK = sdO + kTile * LD;                // [kTile][LD]
  bf16* sV = sK + kTile * LD;                 // [kTile][LD]
  bf16* sKt = sV + kTile * LD;                // [D][LDT]

  const int b = blockIdx.y;
  const int qt = blockIdx.x;
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  const long long plane = static_cast<long long>(p.S) * D;
  const bf16* q = static_cast<const bf16*>(p.q) + b * plane;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * plane;
  const bf16* k = static_cast<const bf16*>(p.k) + kv_row(p, b) * plane;
  const bf16* v = static_cast<const bf16*>(p.v) + kv_row(p, b) * plane;
  const float* mask = mask_rows(p, b);

  tc_load<D>(sQ, q, q0, p.S);
  tc_load<D>(sdO, dout, q0, p.S);
  float lse[2], delta[2], dq[NT][4] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + (lane >> 2) + h * 8;
    const long long at = static_cast<long long>(b) * p.S + row;
    lse[h] = row < p.S ? p.lse_in[at] : 0.f;
    delta[h] = row < p.S ? p.delta[at] : 0.f;
  }
  const int nk = (p.S + kTile - 1) / kTile;
  const int last = p.causal ? qt : nk - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    tc_load<D>(sK, k, k0, p.S);
    tc_load<D>(sV, v, k0, p.S);
    tc_load_t<D>(sKt, k, k0, p.S);
    __syncthreads();

    float s[8][4] = {}, dp[8][4] = {};
    mma_smem<8, D>(s, sQ, LD, r0, sK, LD, lane);
    mma_smem<8, D>(dp, sdO, LD, r0, sV, LD, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + frag_row(lane, e);
        const int col = k0 + frag_col(lane, nt, e);
        const float x = score(p, mask, s[nt][e], row, col);
        float pr = expf(x - lse[e >> 1]);
        pr = x <= 0.5f * kMask ? 0.f : pr;
        float d = dp[nt][e];
        if (p.dropout) d = keep(p, b, row, col) ? d / p.keep_div : 0.f;
        s[nt][e] = pr * (d - delta[e >> 1]) * p.scale;
      }
    uint32_t dsa[4][4];
    pack_a(dsa, s);
    mma_regs<NT>(dq, dsa, sKt, LDT, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<NT>(static_cast<bf16*>(p.dq) + b * plane, dq, q0 + r0, lane,
                 p.S, D, one);
}

template <int D>
constexpr size_t tc_dkv_smem() {
  return sizeof(bf16) * (4 * kTile * (D + kPadH) + 2 * D * (kTile + kPadH)) +
         sizeof(float) * 2 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_dkv_tc_kernel(Params p) {
  constexpr int LD = D + kPadH, LDT = kTile + kPadH, NT = D / 8;
  extern __shared__ float4 smem4[];
  float* sLse = reinterpret_cast<float*>(smem4);  // [kTile]
  float* sDelta = sLse + kTile;                   // [kTile]
  bf16* sK = reinterpret_cast<bf16*>(sDelta + kTile);  // [kTile][LD]
  bf16* sV = sK + kTile * LD;                     // [kTile][LD]
  bf16* sQ = sV + kTile * LD;                     // [kTile][LD]
  bf16* sdO = sQ + kTile * LD;                    // [kTile][LD]
  bf16* sQt = sdO + kTile * LD;                   // [D][LDT]
  bf16* sdOt = sQt + D * LDT;                     // [D][LDT]

  const int b = blockIdx.y;
  const int kt = blockIdx.x;
  const int k0 = kt * kTile;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's keys in the tile
  const long long plane = static_cast<long long>(p.S) * D;
  const bf16* q = static_cast<const bf16*>(p.q) + b * plane;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * plane;
  const bf16* k = static_cast<const bf16*>(p.k) + kv_row(p, b) * plane;
  const bf16* v = static_cast<const bf16*>(p.v) + kv_row(p, b) * plane;
  const float* mask = mask_rows(p, b);

  tc_load<D>(sK, k, k0, p.S);
  tc_load<D>(sV, v, k0, p.S);
  float dk[NT][4] = {}, dv[NT][4] = {};
  const int nq = (p.S + kTile - 1) / kTile;
  for (int qt = p.causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    tc_load<D>(sQ, q, q0, p.S);
    tc_load<D>(sdO, dout, q0, p.S);
    tc_load_t<D>(sQt, q, q0, p.S);
    tc_load_t<D>(sdOt, dout, q0, p.S);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const long long at = static_cast<long long>(b) * p.S + row;
      sLse[threadIdx.x] = row < p.S ? p.lse_in[at] : 0.f;
      sDelta[threadIdx.x] = row < p.S ? p.delta[at] : 0.f;
    }
    __syncthreads();

    // transposed tiles: element (key, query)
    float st[8][4] = {}, dpt[8][4] = {};
    mma_smem<8, D>(st, sK, LD, r0, sQ, LD, lane);
    mma_smem<8, D>(dpt, sV, LD, r0, sdO, LD, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + r0 + frag_row(lane, e);
        const int qi = frag_col(lane, nt, e);
        const int row = q0 + qi;
        const float x = score(p, mask, st[nt][e], row, col);
        float pr = expf(x - sLse[qi]);
        pr = x <= 0.5f * kMask ? 0.f : pr;
        float pd = pr, d = dpt[nt][e];
        if (p.dropout) {
          const bool kp = keep(p, b, row, col);
          pd = kp ? pr / p.keep_div : 0.f;
          d = kp ? d / p.keep_div : 0.f;
        }
        st[nt][e] = pd;
        dpt[nt][e] = pr * (d - sDelta[qi]) * p.scale;
      }
    uint32_t a[4][4];
    pack_a(a, st);
    mma_regs<NT>(dv, a, sdOt, LDT, lane);
    pack_a(a, dpt);
    mma_regs<NT>(dk, a, sQt, LDT, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<NT>(static_cast<bf16*>(p.dk) + b * plane, dk, k0 + r0, lane,
                 p.S, D, one);
  store_rows<NT>(static_cast<bf16*>(p.dv) + b * plane, dv, k0 + r0, lane,
                 p.S, D, one);
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

// bf16 inputs: the tensor-core kernels
template <int D>
cudaError_t run_bf16(Which which, int BH, const Params& p, cudaStream_t st) {
  const int tiles = (p.S + kTile - 1) / kTile;
  switch (which) {
    case kFwd:
      return launch(flash_fwd_tc_kernel<D>, tc_fwd_smem<D>(), kTcThreads,
                    tiles, BH, p, st);
    case kDq:
      return launch(flash_dq_tc_kernel<D>, tc_dq_smem<D>(), kTcThreads, tiles,
                    BH, p, st);
    case kDkv:
      return launch(flash_dkv_tc_kernel<D>, tc_dkv_smem<D>(), kTcThreads,
                    tiles, BH, p, st);
  }
  return cudaErrorInvalidValue;
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

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
