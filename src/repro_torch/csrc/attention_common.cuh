// Helpers shared by the attention kernels (flash_attention.cu,
// decode_attention.cu): element conversion, 16-byte row loads, warp
// reductions and the template dispatch over element type and head width.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int DTYPE_F32 = 0;    // element codes passed by the wrappers
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// Elements of T in one 16-byte load.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// Load Vec<T>::N consecutive elements (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

// Reductions over lane groups of WIDTH consecutive lanes (WIDTH <= 32).
template <int WIDTH>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int WIDTH>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// exp(a - b) where a or b may be -inf: 0 unless a is finite.
__device__ __forceinline__ float exp_diff(float a, float b) {
  return a == -INFINITY ? 0.f : expf(a - b);
}

}  // namespace attn

// Calls F.template operator()<T, HD>() for the element code and head width
// the wrapper passed; returns cudaErrorInvalidValue for any other.
template <typename F>
static int dispatch_type_hd(int dtype, int hd, F&& f) {
  if (dtype == attn::DTYPE_F32) {
    switch (hd) {
      case 16: return f.template operator()<float, 16>();
      case 32: return f.template operator()<float, 32>();
      case 64: return f.template operator()<float, 64>();
      case 128: return f.template operator()<float, 128>();
    }
  } else if (dtype == attn::DTYPE_BF16) {
    switch (hd) {
      case 16: return f.template operator()<__nv_bfloat16, 16>();
      case 32: return f.template operator()<__nv_bfloat16, 32>();
      case 64: return f.template operator()<__nv_bfloat16, 64>();
      case 128: return f.template operator()<__nv_bfloat16, 128>();
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
