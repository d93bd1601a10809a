// Paged attention for Hopper (sm_90a): the block table is walked inside the
// kernel, so the dense per-slot K/V view is never materialised.
//
// Replaces the Pallas TPU kernel `_kernel` of
// paddle_tpu/ops/pallas/paged_attention.py (launched by `paged_attention`),
// in both of its modes: float pools (f32, or bf16 with f32 accumulation) and
// int8 pools with per-(block, head) f32 scales dequantised in-kernel as
// `float(code) * (scale / qmax)`, in exactly that order, so the kernel sees
// the values `serving.blocks.dequant` computes.
//
// What it computes, for q [S, T, H, D] whose T tokens sit at positions
// pos[s] .. pos[s]+T-1 of slot s, against pools [N, bs, H, D] through
// tables [S, nb] (int32 physical block ids, 0 = the garbage block):
//   * key position j is visible to query i iff j <= pos[s] + i;
//   * masked scores are filled with the finite -1e30, and p = 0 exactly where
//     score <= -0.5e30 (a fully masked chunk must not add exp(0) = 1);
//   * V rows past the tile's last visible position are replaced by 0 with a
//     select: the garbage block may hold inf/NaN, and 0 * inf is NaN;
//   * a row with no visible key (l == 0) emits exact zeros.
//
// Design. One thread block per (slot, head, tile of TQ query rows): TQ = 1
// for decode (T = 1), 16 otherwise, so a decode step computes no discarded
// rows. The block reads its own tables[s, j] and pos[s] (the TPU kernel's
// scalar prefetch) and walks the keys in chunks of 64, across block edges
// (each key finds its physical row through the table), only up to the
// tile's last visible position: keys past it are never read, so a slot at
// position p costs p + T key rows, not nb * bs. K and V of one chunk are
// staged in shared memory as f32, dequantised or widened on the way in; each
// thread issues all of its 16-byte loads of the chunk before it uses any, so
// many loads are in flight. K rows are padded by one word so the score loop
// is free of bank conflicts. The running max, sum and the [TQ, D]
// accumulator stay in shared memory in f32 (the flash recurrence).
//
// Bound on this card. Decode (T = 1) does 4 * D flops per visible key and
// head against 2 * D * sizeof(pool elem) bytes: far below the H100's
// flop:byte balance, so it is bandwidth-bound and the least time is the
// live-KV bytes (each visible K and V row read once) over the HBM rate.
// Prefill tiles reuse each staged chunk for 16 query rows.
//
// Known weaknesses, left for a redesign: at T = 1 the grid is only
// slots * heads thread blocks (96 at 8 slots x 12 heads on 132 SMs), each
// walking its whole KV length alone, with no split over the KV length and
// reduce; chunk loads are not overlapped with the arithmetic (no cp.async or
// TMA pipeline); the products run on CUDA cores in f32, with no wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMask = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // keys staged per step, across block edges

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The shared memory a launch needs; `paged_attention_smem_bytes` hands the
// same number to the wrapper in ops/paged_attention.py.
size_t smem_bytes(int tq, int d) {
  return sizeof(float) * (2 * tq * d + kChunk * (d + 1) + kChunk * d +
                          tq * kChunk + 3 * tq + 2 * kChunk) +
         sizeof(long long) * kChunk;
}

// Element t of 16 bytes of pool elements, widened to f32.
template <typename KVT>
__device__ __forceinline__ float elem(const uint4& raw, int t) {
  return to_f32(reinterpret_cast<const KVT*>(&raw)[t]);
}

template <typename QT, typename KVT, int D, int TQ, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ pos, QT* __restrict__ out, int T, int H, int bs,
    int nb, float scale, float qmax) {
  constexpr int KS = D + 1;                      // padded K row stride
  constexpr int VN = 16 / sizeof(KVT);           // elements per 16 bytes
  constexpr int VPR = D / VN;                    // vectors per key row
  constexpr int NV = kChunk * VPR;               // vectors per chunk
  constexpr int PER = (NV + kThreads - 1) / kThreads;
  static_assert(D % VN == 0, "a key row must be whole 16-byte vectors");

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * TQ;
  const int rows = min(TQ, T - q0);
  const int p0 = pos[s];
  // last key position any query row of this tile can see
  const int q_hi = p0 + q0 + rows - 1;
  const int n_keys = min(q_hi + 1, nb * bs);     // keys this tile walks

  // 8-byte row offsets first: the dynamic shared memory base is aligned
  extern __shared__ long long smem[];
  long long* srow = smem;           // [kChunk] element offset, -1 = none
  float* sq = reinterpret_cast<float*>(srow + kChunk);  // [TQ][D] queries
  float* sacc = sq + TQ * D;        // [TQ][D] accumulator
  float* sk = sacc + TQ * D;        // [kChunk][KS] one chunk of K
  float* sv = sk + kChunk * KS;     // [kChunk][D] one chunk of V
  float* sp = sv + kChunk * D;      // [TQ][kChunk] scores, then p
  float* sm = sp + TQ * kChunk;     // [TQ] running max
  float* sl = sm + TQ;              // [TQ] running sum
  float* sa = sl + TQ;              // [TQ] this chunk's rescale
  float* sks = sa + TQ;             // [kChunk] K scale / qmax per key
  float* svs = sks + kChunk;        // [kChunk] V scale / qmax per key

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long tok = static_cast<long long>(H) * D;  // token stride

  for (int e = tid; e < TQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r < rows) {
      x = to_f32(q[(static_cast<long long>(s) * T + q0 + r) * tok +
                   static_cast<long long>(h) * D + d]);
    }
    sq[e] = x;
    sacc[e] = 0.f;
  }
  if (tid < TQ) {
    sm[tid] = kMask;
    sl[tid] = 0.f;
  }

  for (int kbase = 0; kbase < n_keys; kbase += kChunk) {
    // where each key of the chunk lives: one table read per key (cached);
    // keys past n_keys are never read, and their V must be 0 anyway
    if (tid < kChunk) {
      const int kp = kbase + tid;
      long long row = -1;
      if (kp < n_keys) {
        const int blk = tables[static_cast<long long>(s) * nb + kp / bs];
        row = (static_cast<long long>(blk) * bs + kp % bs) * tok +
              static_cast<long long>(h) * D;
        if (QUANT) {
          sks[tid] = k_scale[static_cast<long long>(blk) * H + h] / qmax;
          svs[tid] = v_scale[static_cast<long long>(blk) * H + h] / qmax;
        }
      }
      srow[tid] = row;
    }
    __syncthreads();

    // stage K and V: every 16-byte load of the chunk is issued before any
    // is used, so a thread keeps PER loads of each pool in flight
    uint4 kr[PER], vr[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int v = tid + i * kThreads;
      kr[i] = make_uint4(0, 0, 0, 0);
      vr[i] = make_uint4(0, 0, 0, 0);
      if (v < NV) {
        const long long row = srow[v / VPR];
        if (row >= 0) {
          const long long off = row + (v % VPR) * VN;
          kr[i] = *reinterpret_cast<const uint4*>(k_pool + off);
          vr[i] = *reinterpret_cast<const uint4*>(v_pool + off);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int v = tid + i * kThreads;
      if (v < NV) {
        const int c = v / VPR, d0 = (v % VPR) * VN;
        const float ks = QUANT ? sks[c] : 1.f;
        const float vs = QUANT ? svs[c] : 1.f;
        const bool live = srow[c] >= 0;
#pragma unroll
        for (int t = 0; t < VN; ++t) {
          float kx = elem<KVT>(kr[i], t);
          float vx = elem<KVT>(vr[i], t);
          if (QUANT && live) {
            kx = kx * ks;
            vx = vx * vs;
          }
          sk[c * KS + d0 + t] = kx;
          sv[c * D + d0 + t] = vx;
        }
      }
    }
    __syncthreads();

    for (int e = tid; e < TQ * kChunk; e += kThreads) {
      const int r = e / kChunk, c = e % kChunk;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += sq[r * D + d] * sk[c * KS + d];
      const bool visible = r < rows && kbase + c < n_keys &&
                           kbase + c <= p0 + q0 + r;
      sp[e] = visible ? dot * scale : kMask;
    }
    __syncthreads();

    for (int r = warp; r < TQ; r += kWarps) {
      float mc = kMask;
      for (int c = lane; c < kChunk; c += 32)
        mc = fmaxf(mc, sp[r * kChunk + c]);
      for (int o = 16; o > 0; o >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mc);
      float sum = 0.f;
      for (int c = lane; c < kChunk; c += 32) {
        const float sc = sp[r * kChunk + c];
        const float p = sc <= 0.5f * kMask ? 0.f : expf(sc - m_new);
        sp[r * kChunk + c] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sa[r] = alpha;
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < TQ * D; e += kThreads) {
      const int r = e / D, d = e % D;
      float pv = 0.f;
#pragma unroll 16
      for (int c = 0; c < kChunk; ++c)
        pv += sp[r * kChunk + c] * sv[c * D + d];
      sacc[e] = sacc[e] * sa[r] + pv;
    }
    __syncthreads();
  }
  __syncthreads();  // the loop may not have run: sacc/sl from the prologue

  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const float l = sl[r];
    store(&out[(static_cast<long long>(s) * T + q0 + r) * tok +
               static_cast<long long>(h) * D + d],
          sacc[e] / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename KVT, int D, int TQ, bool QUANT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* pos, void* out, int S,
                   int T, int H, int bs, int nb, float scale, float qmax,
                   cudaStream_t stream) {
  const dim3 grid(S, H, (T + TQ - 1) / TQ);
  const size_t smem = smem_bytes(TQ, D);
  auto kern = paged_attention_kernel<QT, KVT, D, TQ, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<QT*>(out), T, H, bs, nb,
      scale, qmax);
  return cudaGetLastError();
}

template <typename QT, typename KVT, int D, bool QUANT>
cudaError_t launch_tile(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale,
                        const void* tables, const void* pos, void* out,
                        int S, int T, int H, int bs, int nb, float scale,
                        float qmax, cudaStream_t st) {
  if (T == 1)
    return launch<QT, KVT, D, 1, QUANT>(q, k_pool, v_pool, k_scale, v_scale,
                                        tables, pos, out, S, T, H, bs, nb,
                                        scale, qmax, st);
  return launch<QT, KVT, D, 16, QUANT>(q, k_pool, v_pool, k_scale, v_scale,
                                       tables, pos, out, S, T, H, bs, nb,
                                       scale, qmax, st);
}

template <int D>
cudaError_t dispatch_mode(int mode, const void* q, const void* k_pool,
                          const void* v_pool, const void* k_scale,
                          const void* v_scale, const void* tables,
                          const void* pos, void* out, int S, int T, int H,
                          int bs, int nb, float scale, float qmax,
                          cudaStream_t st) {
  switch (mode) {
    case 0:
      return launch_tile<float, float, D, false>(
          q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, S, T, H, bs,
          nb, scale, qmax, st);
    case 1:
      return launch_tile<__nv_bfloat16, __nv_bfloat16, D, false>(
          q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, S, T, H, bs,
          nb, scale, qmax, st);
    case 2:
      return launch_tile<float, int8_t, D, true>(
          q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, S, T, H, bs,
          nb, scale, qmax, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 = f32 q / f32 pools, 1 = bf16 q / bf16 pools,
//       2 = f32 q / int8 pools + f32 scales. Head dim 64 only (GPT-125M's,
//       the one the card checks run).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* pos, void* out, int S, int T,
                                   int H, int D, int bs, int nb, float scale,
                                   float qmax, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64) return cudaErrorInvalidValue;
  return dispatch_mode<64>(mode, q, k_pool, v_pool, k_scale, v_scale, tables,
                           pos, out, S, T, H, bs, nb, scale, qmax, st);
}

// Shared memory one launch needs (the wrapper refuses what the card lacks).
extern "C" int paged_attention_smem_bytes(int T, int D, int bs) {
  return static_cast<int>(smem_bytes(T == 1 ? 1 : 16, D));
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
