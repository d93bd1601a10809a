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
// Design, decode (T = 1): the KV length is split. One thread block per
// (split of kSplit keys, head, slot), so a decode step over 8 slots x 12
// heads fills the card whatever the positions. The grid is sized from the
// table's capacity nb * bs, never from pos (reading pos on the host would
// stall the stream every layer): a block reads pos[s] itself and a split
// that lies wholly past the slot's last visible key exits at once. Each of
// a block's four warps walks its own keys, 8 at a time, with every key
// row's address taken from tables[s, j] (the split's table entries are
// read beside pos, the int8 scale rows beside the first copies); its
// 16-byte cp.async copies go into a 2-stage ring in shared memory, so the
// next step's loads are in flight while it computes one. Lanes split a key
// row into 16-byte chunks, reduce the dot product with shuffles and keep an
// online softmax per warp; the four warps merge in shared memory. Where a
// slot has one live split, that split writes the output itself; otherwise
// every live split writes its partial (m, l, acc[D]) in f32 to scratch
// and takes a ticket (atomic, after __threadfence) on its (slot, head)
// counter, and the last one merges the partials in split order, so results
// repeat bit for bit, and resets the counter for the next call. One launch
// a call.
//
// Design, prefill (T > 1): one thread block per (slot, head, tile of 16
// query rows). The block reads its own tables[s, j] and pos[s] (the TPU
// kernel's scalar prefetch) and walks the keys in chunks of 64, across
// block edges, only up to the tile's last visible position: keys past it
// are never read, so a slot at position p costs p + T key rows, not
// nb * bs. K and V of one chunk are staged in shared memory as f32,
// dequantised or widened on the way in; each thread issues all of its
// 16-byte loads of the chunk before it uses any. K rows are padded by one
// word so the score loop is free of bank conflicts. The running max, sum
// and the [16, D] accumulator stay in shared memory in f32.
//
// Bound on this card. Decode (T = 1) does 4 * D flops per visible key and
// head against 2 * D * sizeof(pool elem) bytes: far below the H100's
// flop:byte balance, so it is bandwidth-bound and the least time is the
// live-KV bytes (each visible K and V row read once) over the HBM rate.
// Prefill tiles reuse each staged chunk for 16 query rows.
//
// Known weaknesses: a decode block covers one head, so its key rows are
// D * sizeof(pool elem) contiguous bytes (64 for int8) rather than the
// whole token's H * D; decode products run on CUDA cores in f32. Prefill
// tiles do not overlap loads with the arithmetic and do not use wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// The shared memory of a prefill launch (tiles of tq query rows);
// `paged_attention_smem_bytes` hands it to the wrapper.
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

// ------------------------------------------------------------ decode (T = 1)
constexpr int kWarpKeys = 8;  // keys a warp stages per step
// cp.async stages a warp keeps: the next step's copies are in flight while
// it computes one. Deeper rings (3, 4) measured slower on the H100 at the
// serving shapes: their shared memory leaves fewer blocks on an SM.
constexpr int kRing = 2;
// keys of one split (one thread block). Measured on the H100 at the serving
// shapes (ring 2): splits of 32 / 64 / 128 / 256 keys took 0.0226 / 0.0199 /
// 0.0191 / 0.0185 ms over f32 pools and 0.0177 / 0.0159 / 0.0155 / 0.0168
// over int8 pools; 128 is the best over both.
constexpr int kSplit = 128;
// table entries a split can touch, at any block size
constexpr int kSplitEntries = kSplit + 1;

// Shared memory of a decode launch over pool elements of `kv_size` bytes:
// each warp's ring of K and V rows, the four warps' (m, l, acc[D]), and the
// split's table entries with their K and V scale / qmax (int8 pools).
size_t decode_smem_bytes(int d, int kv_size) {
  return static_cast<size_t>(kWarps) * kRing * 2 * kWarpKeys * d * kv_size +
         sizeof(float) * kWarps * (d + 2) + sizeof(int) * 3 * kSplitEntries;
}

template <typename QT, typename KVT, int D, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ pos, QT* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int H, int bs,
    int nb, float scale, float qmax) {
  constexpr int VN = 16 / sizeof(KVT);  // elements per 16 bytes
  constexpr int G = D / VN;             // lanes that share one key row
  constexpr int KP = 32 / G;            // keys a warp covers per pass
  constexpr int PASSES = kWarpKeys / KP;
  constexpr int RB = D * sizeof(KVT);   // bytes of one key row of a head
  constexpr int STAGE = 2 * kWarpKeys * RB;
  static_assert(D % VN == 0 && 32 % G == 0 && kWarpKeys % KP == 0,
                "a warp pass covers whole 16-byte chunks of whole rows");

  const int split_i = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long tok = static_cast<long long>(H) * D;  // token stride
  QT* o = out + s * tok + static_cast<long long>(h) * D;
  const int j0 = split_i * kSplit;
  const int e0 = j0 / bs;  // the split's first table entry
  const int n_ent = min((j0 + kSplit - 1) / bs, nb - 1) - e0 + 1;

  extern __shared__ uint4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4) +
                  static_cast<size_t>(warp) * kRing * STAGE;
  float* wstate = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(smem4) +
      static_cast<size_t>(kWarps) * kRing * STAGE);  // [kWarps][D + 2]
  int* sblk = reinterpret_cast<int*>(wstate + kWarps * (D + 2));
  float* sks = reinterpret_cast<float*>(sblk + kSplitEntries);
  float* svs = sks + kSplitEntries;
  __shared__ int last_block;

  // the split's table entries are read beside pos, not after it
  for (int x = tid; x < n_ent; x += kThreads)
    sblk[x] = tables[static_cast<long long>(s) * nb + e0 + x];
  // keys visible to the token, and the splits that hold any of them
  const int n_keys = min(pos[s] + 1, nb * bs);
  const int n_live = n_keys > 0 ? (n_keys + kSplit - 1) / kSplit : 0;
  if (split_i >= n_live) {
    // no visible key in this split; a slot with none at all (pos = -1)
    // emits exact zeros from its first split
    if (n_live == 0 && split_i == 0)
      for (int d = tid; d < D; d += kThreads) store(&o[d], 0.f);
    return;
  }
  const int j_end = min(j0 + kSplit, n_keys);  // split's keys: [j0, j_end)
  const int n_steps =
      (j_end - j0 + kWarps * kWarpKeys - 1) / (kWarps * kWarpKeys);
  __syncthreads();  // sblk

  // the warp's keys of a step: jb .. jb + kWarpKeys - 1
  auto first_key = [&](int step) {
    return j0 + (step * kWarps + warp) * kWarpKeys;
  };
  // one step's K and V rows into its stage: lane x copies 16-byte chunk
  // x % G of key x / G; keys past j_end are not read (their V is selected
  // to 0 below, their scores masked)
  auto issue = [&](int step) {
    uint8_t* sk = ring + (step % kRing) * STAGE;
    const int jb = first_key(step);
#pragma unroll
    for (int r = 0; r < kWarpKeys * G / 32; ++r) {
      const int x = lane + 32 * r;
      const int c = x / G, ch = x % G;
      const int j = jb + c;
      if (j < j_end) {
        const int blk = sblk[j / bs - e0];
        const long long off =
            (static_cast<long long>(blk) * bs + j % bs) * tok +
            static_cast<long long>(h) * D + ch * VN;
        hopper::cp_async16(sk + c * RB + ch * 16, k_pool + off);
        hopper::cp_async16(sk + kWarpKeys * RB + c * RB + ch * 16,
                           v_pool + off);
      }
    }
    hopper::cp_async_commit();
  };

  // int8: the scale / qmax of each block of the split, in that order;
  // they load while the first steps' copies are in flight
  if (QUANT)
    for (int x = tid; x < n_ent; x += kThreads) {
      const long long at = static_cast<long long>(sblk[x]) * H + h;
      sks[x] = k_scale[at] / qmax;
      svs[x] = v_scale[at] / qmax;
    }
#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) issue(st);

  // the lane's 16-byte chunk of the query row, in f32
  float qv[VN];
  const QT* qrow = q + s * tok + static_cast<long long>(h) * D +
                   (lane % G) * VN;
#pragma unroll
  for (int e = 0; e < VN; ++e) qv[e] = to_f32(qrow[e]);

  float m = kMask, l = 0.f, acc[VN];
#pragma unroll
  for (int e = 0; e < VN; ++e) acc[e] = 0.f;
  if (QUANT) __syncthreads();  // sks, svs

  for (int step = 0; step < n_steps; ++step) {
    issue(step + kRing - 1);  // into the stage read at step - 1
    hopper::cp_async_wait<kRing - 1>();
    __syncwarp();  // every lane's copies of this step have landed
    const uint8_t* sk = ring + (step % kRing) * STAGE;
    const uint8_t* sv = sk + kWarpKeys * RB;
    const int jb = first_key(step);

    // scores: pass pp puts key pp * KP + lane / G under lane; its G lanes
    // hold the same sum after the butterfly
    float sc[PASSES];
    float mc = kMask;
#pragma unroll
    for (int pp = 0; pp < PASSES; ++pp) {
      const int c = pp * KP + lane / G;
      const int j = jb + c;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(sk + c * RB + (lane % G) * 16);
      const float ks = QUANT && j < j_end ? sks[j / bs - e0] : 1.f;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        float kx = elem<KVT>(raw, e);
        if (QUANT) kx = kx * ks;
        dot = fmaf(qv[e], kx, dot);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      sc[pp] = j < j_end ? dot * scale : kMask;
      mc = fmaxf(mc, sc[pp]);
    }
    // over the warp's keys (lanes that differ in the key bits)
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
    const float m_new = fmaxf(m, mc);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int pp = 0; pp < PASSES; ++pp) {
      sc[pp] = sc[pp] <= 0.5f * kMask ? 0.f : expf(sc[pp] - m_new);
      sum += sc[pp];
    }
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l = l * alpha + sum;
    m = m_new;

    // acc += p . V over the lane's keys and its chunk of D
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[e] *= alpha;
#pragma unroll
    for (int pp = 0; pp < PASSES; ++pp) {
      const int c = pp * KP + lane / G;
      const int j = jb + c;
      const bool live = j < j_end;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(sv + c * RB + (lane % G) * 16);
      const float vs = QUANT && live ? svs[j / bs - e0] : 1.f;
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        float vx = elem<KVT>(raw, e);
        if (QUANT) vx = vx * vs;
        acc[e] = fmaf(sc[pp], live ? vx : 0.f, acc[e]);
      }
    }
    __syncwarp();  // the stage is read: the next issue may refill it
  }
  hopper::cp_async_wait<0>();  // no copy may land after the block exits

  // the warp's acc over its keys, then the block's over its warps
#pragma unroll
  for (int e = 0; e < VN; ++e)
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  float* ws = wstate + warp * (D + 2);
  if (lane < G)
#pragma unroll
    for (int e = 0; e < VN; ++e) ws[2 + lane * VN + e] = acc[e];
  if (lane == 0) {
    ws[0] = m;
    ws[1] = l;
  }
  __syncthreads();

  float* pp_out = part + ((static_cast<long long>(s) * H + h) * n_split +
                          split_i) * (D + 2);
  if (tid < D) {
    float M = kMask;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wstate[w * (D + 2)]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* x = wstate + w * (D + 2);
      const float wt = x[0] <= 0.5f * kMask ? 0.f : expf(x[0] - M);
      L += x[1] * wt;
      A += x[2 + tid] * wt;
    }
    if (n_live == 1) {
      store(&o[tid], A / (L == 0.f ? 1.f : L));
    } else {
      pp_out[2 + tid] = A;
      if (tid == 0) {
        pp_out[0] = M;
        pp_out[1] = L;
      }
    }
  }
  if (n_live == 1) return;

  // the last split of this (slot, head) to finish merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = tickets + static_cast<long long>(s) * H + h;
    last_block = atomicAdd(ticket, 1) == n_live - 1;
    if (last_block) atomicExch(ticket, 0);  // ready for the next call
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if (tid < D) {
    const float* pb =
        part + (static_cast<long long>(s) * H + h) * n_split * (D + 2);
    float M = kMask;
    for (int i = 0; i < n_live; ++i) M = fmaxf(M, __ldcg(pb + i * (D + 2)));
    float L = 0.f, A = 0.f;
    for (int i = 0; i < n_live; ++i) {  // in split order
      const float* x = pb + i * (D + 2);
      const float mi = __ldcg(x);
      const float wt = mi <= 0.5f * kMask ? 0.f : expf(mi - M);
      L += __ldcg(x + 1) * wt;
      A += __ldcg(x + 2 + tid) * wt;
    }
    store(&o[tid], A / (L == 0.f ? 1.f : L));
  }
}

// ------------------------------------------------------------------ launch
template <typename QT, typename KVT, int D, bool QUANT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* pos, void* out,
                   void* part, void* tickets, int S, int T, int H, int bs,
                   int nb, float scale, float qmax, cudaStream_t stream) {
  const QT* qp = static_cast<const QT*>(q);
  const KVT* kp = static_cast<const KVT*>(k_pool);
  const KVT* vp = static_cast<const KVT*>(v_pool);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  QT* op = static_cast<QT*>(out);
  if (T == 1) {
    if (part == nullptr || tickets == nullptr) return cudaErrorInvalidValue;
    const size_t smem = decode_smem_bytes(D, sizeof(KVT));
    auto kern = paged_decode_kernel<QT, KVT, D, QUANT>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    const dim3 grid((nb * bs + kSplit - 1) / kSplit, H, S);
    kern<<<grid, kThreads, smem, stream>>>(
        qp, kp, vp, ks, vs, tb, ps, op, static_cast<float*>(part),
        static_cast<int*>(tickets), H, bs, nb, scale, qmax);
    return cudaGetLastError();
  }
  constexpr int TQ = 16;
  const size_t smem = smem_bytes(TQ, D);
  auto kern = paged_attention_kernel<QT, KVT, D, TQ, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(S, H, (T + TQ - 1) / TQ);
  kern<<<grid, kThreads, smem, stream>>>(qp, kp, vp, ks, vs, tb, ps, op, T,
                                         H, bs, nb, scale, qmax);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_mode(int mode, const void* q, const void* k_pool,
                          const void* v_pool, const void* k_scale,
                          const void* v_scale, const void* tables,
                          const void* pos, void* out, void* part,
                          void* tickets, int S, int T, int H, int bs, int nb,
                          float scale, float qmax, cudaStream_t st) {
  switch (mode) {
    case 0:
      return launch<float, float, D, false>(
          q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, part,
          tickets, S, T, H, bs, nb, scale, qmax, st);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16, D, false>(
          q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, part,
          tickets, S, T, H, bs, nb, scale, qmax, st);
    case 2:
      return launch<float, int8_t, D, true>(
          q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, part,
          tickets, S, T, H, bs, nb, scale, qmax, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int kv_size(int mode) { return mode == 0 ? 4 : mode == 1 ? 2 : 1; }

}  // namespace

// mode: 0 = f32 q / f32 pools, 1 = bf16 q / bf16 pools,
//       2 = f32 q / int8 pools + f32 scales. Head dim 64 only (GPT-125M's,
//       the one the card checks run). At T = 1 the KV length is cut into
//       splits of `paged_attention_decode_split()` keys: `part` is f32
//       scratch [S][H][ceil(nb * bs / split)][D + 2] (no initial value),
//       `tickets` int32 [S][H], all 0 before the first call and left 0 by
//       every call; calls that share `tickets` must run in stream order.
//       Both are unused for T > 1.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* pos, void* out, void* part,
                                   void* tickets, int S, int T, int H, int D,
                                   int bs, int nb, float scale, float qmax,
                                   int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64) return cudaErrorInvalidValue;
  return dispatch_mode<64>(mode, q, k_pool, v_pool, k_scale, v_scale, tables,
                           pos, out, part, tickets, S, T, H, bs, nb, scale,
                           qmax, st);
}

// Shared memory one launch needs (the wrapper refuses what the card lacks).
extern "C" int paged_attention_smem_bytes(int T, int D, int mode) {
  return static_cast<int>(T == 1 ? decode_smem_bytes(D, kv_size(mode))
                                 : smem_bytes(16, D));
}

// Keys of one decode split (the wrapper sizes `part` from it).
extern "C" int paged_attention_decode_split() { return kSplit; }

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
