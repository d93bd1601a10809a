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
//   * V rows past the last position a launch's rows can see are never
//     multiplied: they are selected or zero-filled to 0, because the garbage
//     block may hold inf/NaN, and 0 * inf is NaN;
//   * a row with no visible key (l == 0) emits exact zeros.
// Products run on the CUDA cores in f32 in every mode (no TF32).
//
// Three launch shapes, one kernel each. All three split the KV length over
// thread blocks and size the grid from the table's capacity nb * bs, never
// from pos (reading pos on the host would stall the stream every layer): a
// block reads pos[s] itself, with the split's table entries, and a split
// that lies wholly past the last key its rows can see exits at once. Where
// a slot (or tile) has one live split, that split writes the output itself;
// otherwise every live split writes its partial (m, l, acc[D]) per row in
// f32 to scratch and takes a ticket (atomic, after __threadfence) on its
// counter, and the last one merges the partials in split order, so results
// repeat bit for bit, and resets the counter for the next call. One launch
// a call.
//
// Decode (T = 1), `paged_decode_kernel`: one block per (split of kSplit
// keys, head, slot), so a decode step over 8 slots x 12 heads fills the
// card whatever the positions. Each of a block's four warps walks its own
// keys, 8 at a time, with every key row's address taken from tables[s, j]
// (the int8 scale rows are read beside the first copies); its 16-byte
// cp.async copies go into a 2-stage ring in shared memory, so the next
// step's loads are in flight while it computes one. Lanes split a key row
// into 16-byte chunks, reduce the dot product with shuffles and keep an
// online softmax per warp; the four warps merge in shared memory.
//
// Windows (T = 2..kWindowRows, speculative verify windows),
// `paged_window_kernel`: the decode design with the window's T query rows
// in every block, so each staged K/V row is read once per (slot, head,
// split) and used for all T rows. The rows live in registers, templated on
// T rounded up (R = 2, 4, 8, 16); the lane's four elements of every row sit
// beside its four elements of the staged key. Each half-warp takes one key
// a pass and keeps its own online softmax per row, with one exp per (key,
// row): the larger of the running max and the score becomes the max. The
// eight half-warp states merge in shared memory over the finished ring.
//
// Tiles (T > kWindowRows, prefill buckets), `paged_tile_kernel`: one block
// per (split of kTileSplit keys, tile of 64 query rows, head, slot), the
// longest tiles first. The tile's queries sit in shared memory in f32; K/V
// chunks of 64 keys (raw pool elements, rows padded by 16 bytes so reads
// are free of bank conflicts) stream through a cp.async ring, the next
// chunk in flight while one computes; keys past the last one the tile can
// see are never read (zero-filled). Products are tiled into registers:
// each thread holds a 4-row x 8-key block of scores and a 4-row x 8-column
// block of the output, so a shared-memory read feeds 8 to 16 FMAs, not
// one. The 8 threads of a row group reduce the row max with shuffles and
// keep their partial sums apart until the end; p goes through shared
// memory (a warp's own rows only) into the P . V product.
//
// Bound on this card. Decode and windows do 4 * D flops per visible (key,
// row) and head against 2 * D * sizeof(pool elem) bytes per key: far below
// the H100's flop:byte balance at T <= 16, so they are bandwidth-bound and
// the least time is the live-KV bytes (each visible K and V row read once)
// over the HBM rate. Prefill tiles reuse each staged chunk for 64 rows and
// are bound by the f32 products on the CUDA cores (67 TFLOP/s).
//
// Known weaknesses: a block covers one head, so its key rows are
// D * sizeof(pool elem) contiguous bytes (64 for int8) rather than the
// whole token's H * D; bf16 pools do not use the tensor cores (wgmma), and
// f32 prefill does not use 3xTF32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kMask = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

// Element t of 16 bytes of pool elements, widened to f32.
template <typename KVT>
__device__ __forceinline__ float elem(const uint4& raw, int t) {
  return to_f32(reinterpret_cast<const KVT*>(&raw)[t]);
}

// Four consecutive pool elements in shared memory (16, 8 or 4 bytes,
// aligned to their size), widened to f32.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  x[0] = static_cast<float>(c.x);
  x[1] = static_cast<float>(c.y);
  x[2] = static_cast<float>(c.z);
  x[3] = static_cast<float>(c.w);
}

// Called by every thread of a block once its split's partial is written:
// true in the last live split of the counter to take a ticket, which
// resets the counter for the next call.
__device__ __forceinline__ bool last_split(int* ticket, int n_live) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == n_live - 1;
    if (last) atomicExch(ticket, 0);  // ready for the next call
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// Merges the partials of n_live splits in split order into `rows` output
// rows at o + r * tok: split i, row r at pb + (i * rows + r) * (D + 2),
// holding (m, l, acc[D]).
template <int D, typename QT>
__device__ void merge_splits(const float* pb, int n_live, int rows, QT* o,
                             long long tok) {
  constexpr int RS = D + 2;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    float M = kMask;
    for (int i = 0; i < n_live; ++i)
      M = fmaxf(M, __ldcg(pb + (static_cast<long long>(i) * rows + r) * RS));
    float L = 0.f, A = 0.f;
    for (int i = 0; i < n_live; ++i) {  // in split order
      const float* x = pb + (static_cast<long long>(i) * rows + r) * RS;
      const float mi = __ldcg(x);
      const float wt = mi <= 0.5f * kMask ? 0.f : expf(mi - M);
      L += __ldcg(x + 1) * wt;
      A += __ldcg(x + 2 + d) * wt;
    }
    store(&o[r * tok + d], A / (L == 0.f ? 1.f : L));
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
// over int8 pools; 128 is the best over both. The window kernel takes the
// same split: at T=5 splits of 64 / 128 / 256 keys took 0.0348 / 0.0328 /
// 0.0319 ms over f32 pools and 0.0348 / 0.0318 / 0.0333 over int8 pools
// (`sweep_paged.py`).
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
  if (!last_split(tickets + static_cast<long long>(s) * H + h, n_live))
    return;
  merge_splits<D>(
      part + (static_cast<long long>(s) * H + h) * n_split * (D + 2), n_live,
      1, o, tok);
}


// ------------------------------------------------ windows (T = 2..16)
// Most query rows the window path takes; longer calls take the tile path.
constexpr int kWindowRows = 16;

// The rows a window launch computes: T rounded up to a template instance.
int window_rows(int t) { return t <= 2 ? 2 : t <= 4 ? 4 : t <= 8 ? 8 : 16; }

// Shared memory of a window launch with R rows: the warps' rings, which the
// eight half-warp states [8][R][D + 2] overlay once the walk is done, then
// the split's table entries with their K and V scale / qmax.
size_t window_smem_bytes(int r, int d, int kv_size) {
  const size_t ring =
      static_cast<size_t>(kWarps) * kRing * 2 * kWarpKeys * d * kv_size;
  const size_t states = sizeof(float) * 2 * kWarps * r * (d + 2);
  return (ring > states ? ring : states) + sizeof(int) * 3 * kSplitEntries;
}

template <typename QT, typename KVT, int D, int R, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_window_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ pos, QT* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int T, int H,
    int bs, int nb, float scale, float qmax) {
  constexpr int VN = 16 / sizeof(KVT);   // copies: elements per 16 bytes
  constexpr int G = D / VN;              // copies: lanes per key row
  constexpr int RB = D * sizeof(KVT);    // bytes of one key row of a head
  constexpr int STAGE = 2 * kWarpKeys * RB;
  constexpr int CL = 16;                 // products: lanes per key row
  constexpr int CE = D / CL;             // products: elements per lane
  constexpr int PASSES = kWarpKeys / 2;  // a pass: one key per half-warp
  constexpr int NG = 2 * kWarps;         // softmax states of a block
  constexpr int RS = D + 2;              // (m, l, acc[D]) of one row
  constexpr size_t RING_BYTES = static_cast<size_t>(kWarps) * kRing * STAGE;
  constexpr size_t STATE_BYTES = sizeof(float) * NG * R * RS;
  static_assert(CE == 4 && D % VN == 0 && 32 % G == 0 &&
                    (kWarpKeys * G) % 32 == 0,
                "a lane takes four elements of a row; copies cover whole "
                "16-byte chunks of whole rows");

  const int split_i = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int half = lane / CL;
  const int cl = lane % CL;
  const long long tok = static_cast<long long>(H) * D;  // token stride
  // row r of the window's output at o + r * tok
  QT* o = out + static_cast<long long>(s) * T * tok +
          static_cast<long long>(h) * D;
  const int j0 = split_i * kSplit;
  const int e0 = j0 / bs;  // the split's first table entry
  const int n_ent = min((j0 + kSplit - 1) / bs, nb - 1) - e0 + 1;

  extern __shared__ uint4 smem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* ring = base + static_cast<size_t>(warp) * kRing * STAGE;
  float* wstate = reinterpret_cast<float*>(base);  // [NG][R][RS], after
  int* sblk = reinterpret_cast<int*>(
      base + (RING_BYTES > STATE_BYTES ? RING_BYTES : STATE_BYTES));
  float* sks = reinterpret_cast<float*>(sblk + kSplitEntries);
  float* svs = sks + kSplitEntries;

  // the split's table entries are read beside pos, not after it
  for (int x = tid; x < n_ent; x += kThreads)
    sblk[x] = tables[static_cast<long long>(s) * nb + e0 + x];
  const int p0 = pos[s];
  // keys some row of the window sees, and the splits that hold any of them
  const int n_keys = min(p0 + T, nb * bs);
  const int n_live = n_keys > 0 ? (n_keys + kSplit - 1) / kSplit : 0;
  if (split_i >= n_live) {
    // no visible key in this split; a window that sees none at all emits
    // exact zeros from its first split
    if (n_live == 0 && split_i == 0)
      for (int e = tid; e < T * D; e += kThreads)
        store(&o[(e / D) * tok + e % D], 0.f);
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
  // one step's K and V rows into its stage, as the decode kernel copies
  // them; keys past j_end are not read
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

  if (QUANT)
    for (int x = tid; x < n_ent; x += kThreads) {
      const long long at = static_cast<long long>(sblk[x]) * H + h;
      sks[x] = k_scale[at] / qmax;
      svs[x] = v_scale[at] / qmax;
    }
#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) issue(st);

  // the lane's four elements of every query row, in f32; rows past T are 0
  float qv[R][CE];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const QT* qrow = q + (static_cast<long long>(s) * T + r) * tok +
                     static_cast<long long>(h) * D + cl * CE;
#pragma unroll
    for (int e = 0; e < CE; ++e) qv[r][e] = r < T ? to_f32(qrow[e]) : 0.f;
  }
  float m[R], l[R], acc[R][CE];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kMask;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < CE; ++e) acc[r][e] = 0.f;
  }
  if (QUANT) __syncthreads();  // sks, svs

  for (int step = 0; step < n_steps; ++step) {
    issue(step + kRing - 1);  // into the stage read at step - 1
    hopper::cp_async_wait<kRing - 1>();
    __syncwarp();  // every lane's copies of this step have landed
    const uint8_t* sk = ring + (step % kRing) * STAGE;
    const uint8_t* sv = sk + kWarpKeys * RB;
    const int jb = first_key(step);
#pragma unroll
    for (int pp = 0; pp < PASSES; ++pp) {
      const int c = pp * 2 + half;
      const int j = jb + c;
      const bool live = j < j_end;
      float kx[CE], vx[CE];
      load4(reinterpret_cast<const KVT*>(sk + c * RB) + cl * CE, kx);
      load4(reinterpret_cast<const KVT*>(sv + c * RB) + cl * CE, vx);
      if (QUANT) {
        const float ks = live ? sks[j / bs - e0] : 1.f;
        const float vs = live ? svs[j / bs - e0] : 1.f;
#pragma unroll
        for (int e = 0; e < CE; ++e) {
          kx[e] = kx[e] * ks;
          vx[e] = vx[e] * vs;
        }
      }
#pragma unroll
      for (int e = 0; e < CE; ++e) vx[e] = live ? vx[e] : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < CE; ++e) dot = fmaf(qv[r][e], kx[e], dot);
#pragma unroll
        for (int off = CL / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float sc = dot * scale;
        // one exp a (key, row): the larger of the running max and the
        // score becomes the max, the other is rescaled by exp(small - big)
        const bool vis = live && j <= p0 + r;
        const bool up = vis && sc > m[r];
        const float ex = expf(up ? m[r] - sc : sc - m[r]);
        const float alpha = up ? ex : 1.f;
        const float p = vis ? (up ? 1.f : ex) : 0.f;
        m[r] = up ? sc : m[r];
        l[r] = fmaf(l[r], alpha, p);
#pragma unroll
        for (int e = 0; e < CE; ++e)
          acc[r][e] = fmaf(p, vx[e], acc[r][e] * alpha);
      }
    }
    __syncwarp();  // the stage is read: the next issue may refill it
  }
  hopper::cp_async_wait<0>();  // no copy may land after the block exits
  __syncthreads();  // every warp is done with its ring: the states overlay it

  {
    float* ws = wstate + (warp * 2 + half) * R * RS;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < T) {
#pragma unroll
        for (int e = 0; e < CE; ++e) ws[r * RS + 2 + cl * CE + e] = acc[r][e];
        if (cl == 0) {
          ws[r * RS] = m[r];
          ws[r * RS + 1] = l[r];
        }
      }
  }
  __syncthreads();

  // split i, row r of this (slot, head) at pb + (i * T + r) * RS
  float* pb = part + (static_cast<long long>(s) * H + h) * n_split * T * RS;
  for (int e = tid; e < T * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float M = kMask;
#pragma unroll
    for (int g = 0; g < NG; ++g) M = fmaxf(M, wstate[(g * R + r) * RS]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float* x = wstate + (g * R + r) * RS;
      const float wt = x[0] <= 0.5f * kMask ? 0.f : expf(x[0] - M);
      L += x[1] * wt;
      A += x[2 + d] * wt;
    }
    if (n_live == 1) {
      store(&o[r * tok + d], A / (L == 0.f ? 1.f : L));
    } else {
      float* x = pb + (static_cast<long long>(split_i) * T + r) * RS;
      x[2 + d] = A;
      if (d == 0) {
        x[0] = M;
        x[1] = L;
      }
    }
  }
  if (n_live == 1) return;

  // the last split of this (slot, head) to finish merges them all
  if (!last_split(tickets + static_cast<long long>(s) * H + h, n_live))
    return;
  merge_splits<D>(pb, n_live, T, o, tok);
}

// --------------------------------------------------------- tiles (T > 16)
constexpr int kTileRowsPer = 4;  // query rows a thread holds
// query rows of a tile: the threads form 16 row groups of 8
constexpr int kTileRows = kThreads / 8 * kTileRowsPer;
// Keys a chunk: 8 for each thread of a group. Measured on the H100 (f32,
// `sweep_paged.py`): 32-key chunks took 0.0858 ms at S=2, T=512 against
// 0.0923 for 64, but 0.0434 against 0.0400 at the serving path's S=1,
// T=256 after a 256-token prefix, and 0.0412 against 0.0395 at T=128.
constexpr int kTileKeys = 64;
// cp.async stages of the K/V ring: the next chunk loads while one computes.
// A third stage (144 KB a block, one block an SM) measured slower at
// T=512: 0.1301 against 0.0921 ms.
constexpr int kTileStages = 2;
// Keys of one split of the tile path. Measured on the H100 (f32, two calls
// of `sweep_paged.py`): splits of 64 / 128 / 256 / 512 keys took 0.1096 /
// 0.0921 / 0.0947 / 0.0965 ms at S=2, T=512 and 0.0505 / 0.0400 / 0.0574 /
// 0.0639 at S=1, T=256 after a 256-token prefix; 128 is the best at both.
constexpr int kTileSplit = 128;
constexpr int kTileSplitEntries = kTileSplit + 1;
// stride of a key's p for the 16 rows of one warp (padded: conflict-free)
constexpr int kTilePS = 4 * kTileRowsPer + 4;

// One row of a tile's partial: (m, l, pad, pad, acc[D]), 16-byte aligned.
int tile_row_floats(int d) { return d + 4; }

// Shared memory of a tile launch: the tile's queries in f32, the K/V ring
// (rows padded by 16 bytes), each warp's p, the per-key scale / qmax of
// every stage (int8 pools) and the split's table entries.
size_t tile_smem_bytes(int d, int kv_size) {
  const size_t rbp = static_cast<size_t>(d) * kv_size + 16;
  return sizeof(float) * kTileRows * (d + 4) +
         static_cast<size_t>(kTileStages) * 2 * kTileKeys * rbp +
         sizeof(float) * kWarps * kTileKeys * kTilePS +
         sizeof(float) * kTileStages * 2 * kTileKeys +
         sizeof(int) * kTileSplitEntries;
}

template <typename QT, typename KVT, int D, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_tile_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ pos, QT* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int T, int H,
    int bs, int nb, float scale, float qmax) {
  constexpr int VN = 16 / sizeof(KVT);  // elements per 16 bytes
  constexpr int CPR = D / VN;           // 16-byte pieces of a key row
  constexpr int RB = D * sizeof(KVT);   // bytes of one key row of a head
  constexpr int RBP = RB + 16;          // padded row in the ring
  constexpr int STAGE = 2 * kTileKeys * RBP;
  constexpr int PER = kTileKeys * CPR / kThreads;  // pieces a thread copies
  constexpr int QS = D + 4;             // padded query row
  constexpr int RPT = kTileRowsPer;
  constexpr int KPT = kTileKeys / 8;    // keys of a thread: cg + 8 * jj
  constexpr int RS = D + 4;             // tile_row_floats
  static_assert(D == 64 && (kTileKeys * CPR) % kThreads == 0,
                "a thread's output columns are cg*4.. and 32 + cg*4..");

  const int split_i = blockIdx.x;
  const int n_split = gridDim.x;
  const int n_tiles = gridDim.y;
  const int tile = n_tiles - 1 - blockIdx.y;  // the longest tiles first
  const int h = blockIdx.z % H;
  const int s = blockIdx.z / H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int rg = tid / 8;  // row group: rows rg * RPT .. + RPT - 1
  const int cg = tid % 8;  // keys cg + 8 * jj; columns cg * 4, 32 + cg * 4
  const long long tok = static_cast<long long>(H) * D;  // token stride
  const int q0 = tile * kTileRows;
  const int rows = min(kTileRows, T - q0);
  // row r of the tile's output at o + r * tok
  QT* o = out + (static_cast<long long>(s) * T + q0) * tok +
          static_cast<long long>(h) * D;
  const int j0 = split_i * kTileSplit;
  const int e0 = j0 / bs;  // the split's first table entry
  const int n_ent = min((j0 + kTileSplit - 1) / bs, nb - 1) - e0 + 1;

  extern __shared__ uint4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kTileRows][QS]
  uint8_t* ring = reinterpret_cast<uint8_t*>(sq + kTileRows * QS);
  float* sp = reinterpret_cast<float*>(ring + kTileStages * STAGE);
  float* skey = sp + kWarps * kTileKeys * kTilePS;  // [stage][K|V][key]
  int* sblk = reinterpret_cast<int*>(skey + kTileStages * 2 * kTileKeys);

  for (int x = tid; x < n_ent; x += kThreads)
    sblk[x] = tables[static_cast<long long>(s) * nb + e0 + x];
  const int p0 = pos[s];
  // keys some row of the tile sees, and the splits that hold any of them
  const int n_keys = min(p0 + q0 + rows, nb * bs);
  const int n_live = n_keys > 0 ? (n_keys + kTileSplit - 1) / kTileSplit : 0;
  if (split_i >= n_live) {
    if (n_live == 0 && split_i == 0)
      for (int e = tid; e < rows * D; e += kThreads)
        store(&o[(e / D) * tok + e % D], 0.f);
    return;
  }
  const int j_end = min(j0 + kTileSplit, n_keys);  // keys: [j0, j_end)
  const int n_chunks = (j_end - j0 + kTileKeys - 1) / kTileKeys;

  __syncthreads();  // sblk

  // one chunk's K and V rows into its stage; keys past j_end are
  // zero-filled, not read (with int8 pools their scales are 0)
  auto issue = [&](int chunk) {
    if (chunk < n_chunks) {
      uint8_t* sk = ring + (chunk % kTileStages) * STAGE;
      uint8_t* sv = sk + kTileKeys * RBP;
      const int jb = j0 + chunk * kTileKeys;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int x = tid + i * kThreads;
        const int c = x / CPR, ch = x % CPR;
        const int j = jb + c;
        const bool live = j < j_end;
        long long off = 0;
        if (live)
          off = (static_cast<long long>(sblk[j / bs - e0]) * bs + j % bs) *
                    tok +
                static_cast<long long>(h) * D + ch * VN;
        hopper::cp_async16_zfill(sk + c * RBP + ch * 16, k_pool + off, live);
        hopper::cp_async16_zfill(sv + c * RBP + ch * 16, v_pool + off, live);
      }
      if (QUANT && tid < kTileKeys) {
        const int j = jb + tid;
        float ks = 0.f, vs = 0.f;
        if (j < j_end) {
          const long long at =
              static_cast<long long>(sblk[j / bs - e0]) * H + h;
          ks = k_scale[at] / qmax;
          vs = v_scale[at] / qmax;
        }
        float* dst = skey + (chunk % kTileStages) * 2 * kTileKeys;
        dst[tid] = ks;
        dst[kTileKeys + tid] = vs;
      }
    }
    hopper::cp_async_commit();  // empty groups keep the count uniform
  };

  float m[RPT], l[RPT], acc[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kMask;
    l[i] = 0.f;  // this thread's share of the row sum, until the end
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }
  const int rl = (rg % 4) * RPT;  // the thread's first row in its warp's 16
  float* spw = sp + warp * kTileKeys * kTilePS;

#pragma unroll
  for (int st = 0; st < kTileStages - 1; ++st) issue(st);
  // the tile's queries in f32, while the first copies are in flight; rows
  // past T are 0 (the first barrier of the walk publishes them)
  for (int e = tid; e < kTileRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    sq[r * QS + d] =
        r < rows ? to_f32(q[(static_cast<long long>(s) * T + q0 + r) * tok +
                            static_cast<long long>(h) * D + d])
                 : 0.f;
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    hopper::cp_async_wait<kTileStages - 2>();
    // this chunk has landed for every thread, and every thread is done
    // with the stage (and its p) that the next issue refills
    __syncthreads();
    issue(chunk + kTileStages - 1);
    const uint8_t* sk = ring + (chunk % kTileStages) * STAGE;
    const uint8_t* sv = sk + kTileKeys * RBP;
    const float* sck = skey + (chunk % kTileStages) * 2 * kTileKeys;
    const int jb = j0 + chunk * kTileKeys;

    // scores of the thread's rows against its keys
    float sc[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) sc[i][jj] = 0.f;
    float ksj[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) ksj[jj] = QUANT ? sck[cg + 8 * jj] : 1.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 qa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sq + (rg * RPT + i) * QS +
                                                 d4 * 4);
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        float kx[4];
        load4(reinterpret_cast<const KVT*>(sk + (cg + 8 * jj) * RBP) + d4 * 4,
              kx);
        if (QUANT)
#pragma unroll
          for (int e = 0; e < 4; ++e) kx[e] = kx[e] * ksj[jj];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float a = sc[i][jj];
          a = fmaf(qa[i].x, kx[0], a);
          a = fmaf(qa[i].y, kx[1], a);
          a = fmaf(qa[i].z, kx[2], a);
          a = fmaf(qa[i].w, kx[3], a);
          sc[i][jj] = a;
        }
      }
    }

    // mask; the online softmax of each row over the chunk (8 threads a row)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lim = p0 + q0 + rg * RPT + i;  // the row's last visible key
      float mx = kMask;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const int j = jb + cg + 8 * jj;
        const bool vis = j < j_end && j <= lim;
        sc[i][jj] = vis ? sc[i][jj] * scale : kMask;
        mx = fmaxf(mx, sc[i][jj]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const float p =
            sc[i][jj] <= 0.5f * kMask ? 0.f : expf(sc[i][jj] - m_new);
        sc[i][jj] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj)
      *reinterpret_cast<float4*>(spw + (cg + 8 * jj) * kTilePS + rl) =
          make_float4(sc[0][jj], sc[1][jj], sc[2][jj], sc[3][jj]);
    __syncwarp();  // a row's p comes from the 8 threads of its group

    // acc += p . V over the chunk's keys, the thread's rows and columns
#pragma unroll 4
    for (int c = 0; c < kTileKeys; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(spw + c * kTilePS +
                                                          rl);
      const float pr[RPT] = {p4.x, p4.y, p4.z, p4.w};
      const KVT* vrow = reinterpret_cast<const KVT*>(sv + c * RBP);
      float v0[4], v1[4];
      load4(vrow + cg * 4, v0);
      load4(vrow + 32 + cg * 4, v1);
      if (QUANT) {
        const float vs = sck[kTileKeys + c];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v0[e] = v0[e] * vs;
          v1[e] = v1[e] * vs;
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][e] = fmaf(pr[i], v0[e], acc[i][e]);
          acc[i][4 + e] = fmaf(pr[i], v1[e], acc[i][4 + e]);
        }
    }
  }
  hopper::cp_async_wait<0>();  // only empty groups can be left

#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);

  if (n_live == 1) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      if (r >= rows) continue;
      const float L = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        store(&o[r * tok + cg * 4 + e], acc[i][e] / L);
        store(&o[r * tok + 32 + cg * 4 + e], acc[i][4 + e] / L);
      }
    }
    return;
  }

  // split i, row r of this (slot, head, tile) at pb + (i * kTileRows + r) * RS
  const long long counter =
      (static_cast<long long>(s) * H + h) * n_tiles + tile;
  float* pb = part + counter * n_split * kTileRows * RS;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i;
    if (r >= rows) continue;
    float* x = pb + (static_cast<long long>(split_i) * kTileRows + r) * RS;
    if (cg == 0) {
      x[0] = m[i];
      x[1] = l[i];
    }
    *reinterpret_cast<float4*>(x + 4 + cg * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(x + 4 + 32 + cg * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }

  // the last split of this (slot, head, tile) to finish merges them all
  if (!last_split(tickets + counter, n_live)) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i;
    if (r >= rows) continue;
    float M = kMask;
    for (int k = 0; k < n_live; ++k)
      M = fmaxf(M, __ldcg(pb + (static_cast<long long>(k) * kTileRows + r) *
                                   RS));
    float L = 0.f, A[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) A[e] = 0.f;
    for (int k = 0; k < n_live; ++k) {  // in split order
      const float* x = pb + (static_cast<long long>(k) * kTileRows + r) * RS;
      const float mk = __ldcg(x);
      const float wt = mk <= 0.5f * kMask ? 0.f : expf(mk - M);
      L += __ldcg(x + 1) * wt;
      const float4 a = __ldcg(reinterpret_cast<const float4*>(x + 4 + cg * 4));
      const float4 b =
          __ldcg(reinterpret_cast<const float4*>(x + 4 + 32 + cg * 4));
      A[0] += a.x * wt;
      A[1] += a.y * wt;
      A[2] += a.z * wt;
      A[3] += a.w * wt;
      A[4] += b.x * wt;
      A[5] += b.y * wt;
      A[6] += b.z * wt;
      A[7] += b.w * wt;
    }
    L = L == 0.f ? 1.f : L;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      store(&o[r * tok + cg * 4 + e], A[e] / L);
      store(&o[r * tok + 32 + cg * 4 + e], A[4 + e] / L);
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int splits(int keys, int split) { return (keys + split - 1) / split; }
int tiles(int t) { return (t + kTileRows - 1) / kTileRows; }

template <typename QT, typename KVT, int D, int R, bool QUANT>
cudaError_t launch_window(const QT* q, const KVT* k_pool, const KVT* v_pool,
                          const float* k_scale, const float* v_scale,
                          const int* tables, const int* pos, QT* out,
                          float* part, int* tickets, int S, int T, int H,
                          int bs, int nb, float scale, float qmax,
                          cudaStream_t stream) {
  const size_t smem = window_smem_bytes(R, D, sizeof(KVT));
  auto kern = paged_window_kernel<QT, KVT, D, R, QUANT>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(splits(nb * bs, kSplit), H, S);
  kern<<<grid, kThreads, smem, stream>>>(q, k_pool, v_pool, k_scale, v_scale,
                                         tables, pos, out, part, tickets, T,
                                         H, bs, nb, scale, qmax);
  return cudaGetLastError();
}

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
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  if (pt == nullptr || tk == nullptr) return cudaErrorInvalidValue;
  if (T == 1) {
    const size_t smem = decode_smem_bytes(D, sizeof(KVT));
    auto kern = paged_decode_kernel<QT, KVT, D, QUANT>;
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(splits(nb * bs, kSplit), H, S);
    kern<<<grid, kThreads, smem, stream>>>(qp, kp, vp, ks, vs, tb, ps, op, pt,
                                           tk, H, bs, nb, scale, qmax);
    return cudaGetLastError();
  }
  if (T <= kWindowRows) {
    switch (window_rows(T)) {
      case 2:
        return launch_window<QT, KVT, D, 2, QUANT>(
            qp, kp, vp, ks, vs, tb, ps, op, pt, tk, S, T, H, bs, nb, scale,
            qmax, stream);
      case 4:
        return launch_window<QT, KVT, D, 4, QUANT>(
            qp, kp, vp, ks, vs, tb, ps, op, pt, tk, S, T, H, bs, nb, scale,
            qmax, stream);
      case 8:
        return launch_window<QT, KVT, D, 8, QUANT>(
            qp, kp, vp, ks, vs, tb, ps, op, pt, tk, S, T, H, bs, nb, scale,
            qmax, stream);
      default:
        return launch_window<QT, KVT, D, 16, QUANT>(
            qp, kp, vp, ks, vs, tb, ps, op, pt, tk, S, T, H, bs, nb, scale,
            qmax, stream);
    }
  }
  const size_t smem = tile_smem_bytes(D, sizeof(KVT));
  auto kern = paged_tile_kernel<QT, KVT, D, QUANT>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(splits(nb * bs, kTileSplit), tiles(T), S * H);
  kern<<<grid, kThreads, smem, stream>>>(qp, kp, vp, ks, vs, tb, ps, op, pt,
                                         tk, T, H, bs, nb, scale, qmax);
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
//       the one the card checks run). `part` is f32 scratch of
//       `paged_attention_partial_floats(...)` floats (no initial value);
//       `tickets` int32, `paged_attention_ticket_count(...)` of them, all 0
//       before the first call and left 0 by every call; calls that share
//       `tickets` must run in stream order.
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
  const int kv = kv_size(mode);
  if (T == 1) return static_cast<int>(decode_smem_bytes(D, kv));
  if (T <= kWindowRows)
    return static_cast<int>(window_smem_bytes(window_rows(T), D, kv));
  return static_cast<int>(tile_smem_bytes(D, kv));
}

// f32 scratch one launch needs for its splits' partials: per (slot, head)
// and split, (m, l, acc[D]) for each query row (decode and windows), or
// per (slot, head, tile) and split, a padded row for each of the tile's
// rows.
extern "C" long long paged_attention_partial_floats(int S, int T, int H,
                                                    int D, int bs, int nb) {
  const long long sh = static_cast<long long>(S) * H;
  if (T <= kWindowRows)
    return sh * splits(nb * bs, kSplit) * T * (D + 2);
  return sh * tiles(T) * splits(nb * bs, kTileSplit) * kTileRows *
         tile_row_floats(D);
}

// Ticket counters one launch takes: one per (slot, head), or per (slot,
// head, tile) on the tile path.
extern "C" long long paged_attention_ticket_count(int S, int T, int H) {
  const long long sh = static_cast<long long>(S) * H;
  return T <= kWindowRows ? sh : sh * tiles(T);
}

// Keys of one decode or window split.
extern "C" int paged_attention_decode_split() { return kSplit; }

// Most query rows of the window path (longer calls take the tile path).
extern "C" int paged_attention_window_rows() { return kWindowRows; }

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
