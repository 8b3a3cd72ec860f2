// Split-K single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention_kernel in
// src/repro/kernels/decode_attention/kernel.py (body _decode_kernel, and
// the merge across splits that the JAX package runs in XLA after the
// pallas_call).  The plain PyTorch version of the same function is
// decode_attention_plain in src/repro_torch/kernels/decode_attention.py,
// with the semantics of decode_attention_ref: fp32 scores scaled by
// 1/sqrt(hd), positions at or past lengths[b] masked out, fp32 softmax and
// PV, the output cast to q's type.
//
// Layouts (all contiguous): q (B, H, hd); k, v (B, S, KV, hd); lengths (B,)
// int32; out (B, H, hd); H = KV * G.  Partials o (B*KV, n_splits, G, hd),
// m and l (B*KV, n_splits, G), fp32.
//
// What bounds it: bytes.  Each key row is used by G query heads only, so a
// decode step does about 2 G flops per byte of cache it reads, far under
// the card's ratio of about 295 bf16 flops per byte.  The kernel's job is
// to read the valid prefix of the cache once and nothing past it.
//
// Design.  decode_split_kernel: one block of 128 threads per (batch, kv
// head, split).  It streams only the keys below min(lengths[b], S) within
// its split, in tiles of 64 keys; each K/V tile is converted to fp32 in
// shared memory once and shared by the G query heads of the group.  Per
// tile: two threads per key compute the G scores (each half of head_dim,
// then a shuffle), one warp per head row takes the tile's max and sum (the
// running fp32 max m and sum l live in shared memory), and each thread
// accumulates its (head row, dim) outputs of P V in registers after
// rescaling them by exp(m_old - m_new).  Any S and any lengths in [1, S]
// are taken: the ragged edge is masked here, not by the caller's shape.
// Any G up to 16 is taken: the kernel is compiled for G rounded up to a
// power of two (GP) and the padding rows of Q are zeros whose results are
// dropped.
// decode_merge_kernel then combines the splits with the renormalized
// flash-decoding merge (kernel.py:108-114) and writes the output.  SIMT fp32
// FMAs only: tensor cores (mma / wgmma) and TMA loads are later work.
#include "attention_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BK = 64;          // keys per tile
static_assert(BK * 2 == THREADS, "two threads per key in the scores");

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  float* o_part;
  float* m_part;
  float* l_part;
  void* out;
  int S, KV, G, n_splits, split_len;
  float scale;
};

template <int HD, int GP>
struct DecodeSmem {
  static constexpr int KST = HD + 8;        // K row stride, in floats
  static constexpr int NT = THREADS / HD;   // thread groups over head rows
  static constexpr int RPT = (GP + NT - 1) / NT;  // head rows per thread
  static constexpr int FLOATS =
      GP * HD + BK * KST + BK * HD + BK * GP + 3 * GP;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename T, int HD, int GP>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const DecodeArgs a) {
  using L = DecodeSmem<HD, GP>;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                       // [GP][HD], scaled, zero padding
  float* Ks = Qs + GP * HD;             // [BK][KST]
  float* Vs = Ks + BK * L::KST;         // [BK][HD]
  float* Ps = Vs + BK * HD;             // [BK][GP]: scores, then weights
  float* m_s = Ps + BK * GP;            // [GP] running max
  float* l_s = m_s + GP;                // [GP] running sum
  float* alpha_s = l_s + GP;            // [GP] this tile's rescale

  const int tid = threadIdx.x;
  const int G = a.G;
  const int split = blockIdx.x;
  const int bh = blockIdx.y;            // b * KV + kv head
  const int b = bh / a.KV, kvh = bh % a.KV;
  const int len = min(a.lengths[b], a.S);
  const int start = split * a.split_len;
  const int end = min(start + a.split_len, len);
  const size_t part = static_cast<size_t>(bh) * a.n_splits + split;

  // PV ownership: dim d, head rows [g0, g0 + RPT)
  const int d = tid % HD;
  const int g0 = (tid / HD) * L::RPT;
  float acc[L::RPT];
#pragma unroll
  for (int r = 0; r < L::RPT; ++r) acc[r] = 0.f;

  if (start < end) {
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    constexpr int VN = attn::Vec<T>::N;
    for (int i = tid; i < GP * HD; i += THREADS)
      Qs[i] = i < G * HD ? attn::to_f(q[static_cast<size_t>(bh) * G * HD + i])
                               * a.scale
                         : 0.f;
    if (tid < GP) {
      m_s[tid] = -INFINITY;
      l_s[tid] = 0.f;
    }
    const size_t row_stride = static_cast<size_t>(a.KV) * HD;
    const size_t base = (static_cast<size_t>(b) * a.S * a.KV + kvh) * HD;
    const int i_pair = tid / 2, half = tid % 2;

    for (int t0 = start; t0 < end; t0 += BK) {
      const int n_valid = min(BK, end - t0);
      // ---- K/V tile -> fp32 shared memory (zeros past the valid keys)
      for (int c = tid; c < BK * (HD / VN); c += THREADS) {
        const int i = c / (HD / VN), dd = (c % (HD / VN)) * VN;
        float kf[VN], vf[VN];
        if (i < n_valid) {
          const size_t off = base + (t0 + i) * row_stride + dd;
          attn::load16(k + off, kf);
          attn::load16(v + off, vf);
        } else {
#pragma unroll
          for (int e = 0; e < VN; ++e) kf[e] = vf[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VN; e += 4) {
          *reinterpret_cast<float4*>(&Ks[i * L::KST + dd + e]) =
              make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
          *reinterpret_cast<float4*>(&Vs[i * HD + dd + e]) =
              make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
        }
      }
      __syncthreads();
      // ---- scores: key i_pair, head-dim chunks (2c + half) * 4
      float s[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) s[g] = 0.f;
#pragma unroll 4
      for (int c = 0; c < HD / 8; ++c) {
        const int col = (2 * c + half) * 4;
        const float4 kk =
            *reinterpret_cast<const float4*>(&Ks[i_pair * L::KST + col]);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float4 qq = *reinterpret_cast<const float4*>(&Qs[g * HD + col]);
          s[g] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
        }
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
        if ((g & 1) == half)
          Ps[i_pair * GP + g] = i_pair < n_valid ? s[g] : -INFINITY;
      }
      __syncthreads();
      // ---- online softmax: one warp per head row
      const int warp = tid / 32, lane = tid % 32;
      for (int g = warp; g < G; g += THREADS / 32) {
        const float x0 = Ps[lane * GP + g], x1 = Ps[(lane + 32) * GP + g];
        const float m_old = m_s[g];
        const float m_new =
            fmaxf(m_old, attn::group_max<32>(fmaxf(x0, x1)));
        const float p0 = attn::exp_diff(x0, m_new);
        const float p1 = attn::exp_diff(x1, m_new);
        Ps[lane * GP + g] = p0;
        Ps[(lane + 32) * GP + g] = p1;
        const float sum = attn::group_sum<32>(p0 + p1);
        if (lane == 0) {
          const float alpha = attn::exp_diff(m_old, m_new);
          alpha_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
      // ---- acc = acc * alpha + P V
#pragma unroll
      for (int r = 0; r < L::RPT; ++r)
        if (g0 + r < G) acc[r] *= alpha_s[g0 + r];
      for (int i = 0; i < n_valid; ++i) {
        const float vv = Vs[i * HD + d];
#pragma unroll
        for (int r = 0; r < L::RPT; ++r)
          if (g0 + r < G) acc[r] += Ps[i * GP + g0 + r] * vv;
      }
      __syncthreads();
    }
  }
  // ---- partial (o, m, l) of this split; an empty split leaves (0, -inf, 0)
#pragma unroll
  for (int r = 0; r < L::RPT; ++r)
    if (g0 + r < G) a.o_part[(part * G + g0 + r) * HD + d] = acc[r];
  if (tid < G) {
    a.m_part[part * G + tid] = start < end ? m_s[tid] : -INFINITY;
    a.l_part[part * G + tid] = start < end ? l_s[tid] : 0.f;
  }
}

// One block per (batch, kv head, head row), one thread per dim.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_merge_kernel(const DecodeArgs a, int G) {
  const int row = blockIdx.x;           // (b * KV + kvh) * G + g
  const int bh = row / G, g = row % G, d = threadIdx.x;
  const size_t first = static_cast<size_t>(bh) * a.n_splits;
  float m_max = -INFINITY;
  for (int s = 0; s < a.n_splits; ++s)
    m_max = fmaxf(m_max, a.m_part[(first + s) * G + g]);
  float l_tot = 0.f, o_tot = 0.f;
  if (m_max != -INFINITY) {
    for (int s = 0; s < a.n_splits; ++s) {
      const size_t p = (first + s) * G + g;
      const float alpha = attn::exp_diff(a.m_part[p], m_max);
      l_tot += a.l_part[p] * alpha;
      o_tot += a.o_part[p * HD + d] * alpha;
    }
  }
  // (b, kvh, g) is head kvh * G + g of batch row b: flat index row
  static_cast<T*>(a.out)[static_cast<size_t>(row) * HD + d] =
      attn::from_f<T>(o_tot / fmaxf(l_tot, 1e-30f));
}

struct Launch {
  DecodeArgs a;
  int B, G;
  cudaStream_t stream;

  template <typename T, int HD, int GP>
  int run() const {
    using L = DecodeSmem<HD, GP>;
    auto kern = decode_split_kernel<T, HD, GP>;
    static bool configured = false;     // once per instantiation
    cudaError_t e;
    if (!configured) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::BYTES));
      if (e != cudaSuccess) return static_cast<int>(e);
      configured = true;
    }
    kern<<<dim3(a.n_splits, B * a.KV), THREADS, L::BYTES, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    decode_merge_kernel<T, HD><<<B * a.KV * G, HD, 0, stream>>>(a, G);
    return static_cast<int>(cudaGetLastError());
  }

  template <typename T, int HD>
  int operator()() const {
    if (G <= 1) return run<T, HD, 1>();
    if (G <= 2) return run<T, HD, 2>();
    if (G <= 4) return run<T, HD, 4>();
    if (G <= 8) return run<T, HD, 8>();
    if (G <= 16) return run<T, HD, 16>();
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

}  // namespace

// Returns cudaGetLastError() after the launches (0 when both were taken).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* o_part, void* m_part, void* l_part, void* out, void* stream,
    int dtype, int B, int S, int KV, int G, int hd, int n_splits,
    int split_len) {
  if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || n_splits <= 0 ||
      split_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l;
  l.a = DecodeArgs{q, k, v, static_cast<const int*>(lengths),
                   static_cast<float*>(o_part), static_cast<float*>(m_part),
                   static_cast<float*>(l_part), out, S, KV, G, n_splits,
                   split_len, 1.0f / sqrtf(static_cast<float>(hd))};
  l.B = B;
  l.G = G;
  l.stream = static_cast<cudaStream_t>(stream);
  return dispatch_type_hd(dtype, hd, l);
}
