// Helpers shared by the attention kernels (flash_attention.cu,
// decode_attention.cu): element conversion, 16-byte row loads, warp
// reductions and the template dispatch over element type and head width
// for the SIMT fp32 kernels; cp.async copies, ldmatrix, mma.sync and the
// fragment layout of the m16n8k16 bf16 product for the tensor-core
// kernels.
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

// The tensor-core kernels take p = exp2f(fmaf(s, sl2, -offset)) for a raw
// score s, sl2 = scale * log2(e) and offset = exp2_offset(m, sl2) of the
// row's running max m.  A row with no unmasked score yet (m = -inf) gets
// offset 0, so a masked score (-inf) gives 0 there too, never a NaN: the
// guard of exp_diff in one fused multiply-add.
__device__ __forceinline__ float exp2_offset(float m, float sl2) {
  return m == -INFINITY ? 0.f : m * sl2;
}

// ---- tensor-core helpers (sm_80 and later; bf16 only)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy in flight; src_bytes 0 fills zeros and
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy rows [0, n_rows) of a row-major bf16 matrix (HD elements a row,
// row_stride elements apart in global memory) into shared rows of ST
// elements; rows from n_valid on are filled with zeros.  Threads tid,
// tid + n_threads, ... each move 16 bytes at a time.
template <int HD, int ST>
__device__ __forceinline__ void cp_async_rows(
    __nv_bfloat16* dst, const __nv_bfloat16* src, size_t row_stride,
    int n_rows, int n_valid, int tid, int n_threads) {
  constexpr int CPR = HD / 8;           // 16-byte chunks a row
  for (int c = tid; c < n_rows * CPR; c += n_threads) {
    const int r = c / CPR, e = (c % CPR) * 8;
    const bool ok = r < n_valid;
    cp_async16(dst + r * ST + e, src + (ok ? r : 0) * row_stride + e,
               ok ? 16 : 0);
  }
}

// Four 8x8 b16 matrices from shared memory.  Lanes 8i..8i+7 give the row
// addresses of matrix i; lane l receives, of each matrix, row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 (with .trans: rows 2 (l % 4) and
// 2 (l % 4) + 1 of column l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b for a 16x16 bf16 A (row-major), a 16x8 bf16 B (column-major)
// and a 16x8 fp32 D.  With g = lane / 4, t = lane % 4 a lane holds
//   A: a[0] (row g, cols 2t, 2t+1), a[1] (row g+8, same cols),
//      a[2] (row g, cols 2t+8, 2t+9), a[3] (row g+8, cols 2t+8, 2t+9);
//   B: b0 (rows 2t, 2t+1 of col g), b1 (rows 2t+8, 2t+9 of col g);
//   D: d[0], d[1] (row g, cols 2t, 2t+1), d[2], d[3] (row g+8, same).
// So the D fragments of two neighbouring 16x8 tiles are, packed in pairs,
// the A fragment of a 16x16 product: no trip through shared memory.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// (x, y) as a bf16 pair hi (x in the low half) and the pair lo of what
// hi leaves over, so that hi + lo holds x and y to about 16 bits.  One
// bf16 rounding of the softmax weights misses the bf16 tolerance near a
// cancelling output (tests/test_torch_attention_tiles.py); the second
// product with lo brings it back.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
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
      case 192: return f.template operator()<float, 192>();
    }
  } else if (dtype == attn::DTYPE_BF16) {
    switch (hd) {
      case 16: return f.template operator()<__nv_bfloat16, 16>();
      case 32: return f.template operator()<__nv_bfloat16, 32>();
      case 64: return f.template operator()<__nv_bfloat16, 64>();
      case 128: return f.template operator()<__nv_bfloat16, 128>();
      case 192: return f.template operator()<__nv_bfloat16, 192>();
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
