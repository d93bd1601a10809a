// o = x * a + b, elementwise: the custom-op recipe's device kernel.
//
// Replaces the Pallas kernel `_scale_shift_kernel` of
// tests/test_custom_op_recipe.py (pallas_call at :54, via `_scale_shift`),
// the recipe that docs/CUSTOM_OPS.md teaches as tier 2. On the TPU the
// kernel is one block over the whole array; here a grid-stride loop walks
// it with as many blocks as fill the card.
//
// Bound: bytes. Each element is read once and written once (8 bytes an
// element in f32, 4 in bf16) for one multiply and one add, far below the
// H100's ~295 operations a byte; so the design only keeps the loads wide:
// 16 bytes a thread (float4, or eight bf16 in a uint4) where both pointers
// are 16-byte aligned, neighbouring threads on neighbouring addresses, and
// a scalar loop for the tail and for unaligned pointers.
//
// Rounding: the multiply and the add round separately (__fmul_rn,
// __fadd_rn), so nvcc cannot contract them into one FMA. That is what the
// plain version `x * a + b` computes, so f32 results equal it bit for bit;
// in bf16 the product is rounded to bf16 before the add, as torch rounds
// the intermediate tensor `x * a`.
//
// Built by `paddle_tpu_torch.utils.cpp_extension.load` with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (recipe/__init__.py). The launch takes the
// caller's stream, does not synchronise and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float op(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

__device__ __forceinline__ __nv_bfloat16 op(__nv_bfloat16 x, float a,
                                            float b) {
  __nv_bfloat16 t = __float2bfloat16_rn(__fmul_rn(__bfloat162float(x), a));
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(t), b));
}

// Elements per 16-byte vector.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    scale_shift_kernel(const T* __restrict__ x, T* __restrict__ o,
                       long long n, float a, float b) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    constexpr int kN = Vec<T>::kN;
    const long long nv = n / kN;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(o);
    for (long long v = i; v < nv; v += stride) {
      uint4 r = __ldg(xv + v);
      T* e = reinterpret_cast<T*>(&r);
#pragma unroll
      for (int k = 0; k < kN; ++k) e[k] = op(e[k], a, b);
      ov[v] = r;
    }
    done = nv * kN;
  }
  for (long long j = done + i; j < n; j += stride) o[j] = op(x[j], a, b);
}

int g_sms = 0;

template <typename T>
cudaError_t launch(const void* x, void* o, long long n, float a, float b,
                   cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(o) % 16 == 0);
  const long long work = vec ? (n + Vec<T>::kN - 1) / Vec<T>::kN : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)g_sms * 8;  // 8 blocks of 256 an SM
  if (blocks > cap) blocks = cap;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(o);
  if (vec)
    scale_shift_kernel<T, true>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(xt, ot, n, a, b);
  else
    scale_shift_kernel<T, false>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(xt, ot, n, a, b);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t (0 on
// success; 1 = cudaErrorInvalidValue for an unknown dtype).
extern "C" int scale_shift_launch(const void* x, void* o, long long n,
                                  float a, float b, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, o, n, a, b, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, o, n, a, b, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* scale_shift_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
