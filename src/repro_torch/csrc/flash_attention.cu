// Causal / non-causal GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_kernel in
// src/repro/kernels/flash_attention/kernel.py (body _attn_kernel).  The
// plain PyTorch version of the same function is flash_attention_plain in
// src/repro_torch/kernels/flash_attention.py, with the semantics of
// flash_attention_ref: fp32 scores scaled by 1/sqrt(hd), key t masked for
// query s when causal and t > s, fp32 softmax and PV, the output cast to
// q's type.  Forward only: the JAX package has no backward for it.
//
// Layouts (all contiguous): q, out (B, S, H, hd); k, v (B, S, KV, hd);
// H = KV * G, query head h reads kv head h / G.
//
// What bounds it: operations.  A (64-query, 64-key) tile does 2 * 64 * 64
// * hd flops for the scores and as many for P V on 64 * hd * 2 elements of
// K and V, far above the card's flops-per-byte ratio, so the tile math is
// the cost.  This first version does it with SIMT fp32 FMAs, which reach a
// small share of the tensor cores' rate; mma / wgmma with TMA-fed
// pipelines are later work.
//
// Design.  One block of 128 threads per (batch, query head, 64-query
// tile); the grid runs the tiles nearest the diagonal's end first.  The
// scaled Q tile stays in shared memory as fp32; K/V tiles of 64 keys are
// streamed through shared memory (converted to fp32 once) with an online
// softmax whose running max m, sum l and the output accumulator stay in
// registers.  Thread (tr, tc) = (tid / 8, tid % 8) owns query rows tr +
// 16 i (i < 4) in both products: key columns tc + 8 j (j < 8) of the
// scores and dims tc + 8 j (j < hd / 8) of the output, so a row's max and
// sum are a shuffle among 8 neighbouring lanes.  When causal, the key loop
// stops at the diagonal tile.  Rows past S and keys past S are masked, so
// any S is taken.  P reuses the K tile's shared memory once the scores are
// done, which keeps a block under 100 KB at hd 128 (two blocks per SM).
#include "attention_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int RI = BQ / 16;     // query rows per thread
constexpr int CJ = BK / 8;      // score columns per thread

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int S, H, KV;
  float scale;
};

template <int HD>
struct FlashSmem {
  static constexpr int QST = HD + 1;    // Q / K row stride, in floats
  static constexpr int PST = BK + 1;    // P row stride
  // K tile, then P in the same place
  static constexpr int KP = BK * QST > BQ * PST ? BK * QST : BQ * PST;
  static constexpr int FLOATS = BQ * QST + KP + BK * HD;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const FlashArgs a) {
  using L = FlashSmem<HD>;
  constexpr int DJ = HD / 8;            // output dims per thread
  constexpr int VN = attn::Vec<T>::N;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                       // [BQ][QST], scaled
  float* Ks = Qs + BQ * L::QST;         // [BK][QST]; then P [BQ][PST]
  float* Vs = Ks + L::KP;               // [BK][HD]
  float* Ps = Ks;

  const int tid = threadIdx.x, tr = tid / 8, tc = tid % 8;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;            // b * H + h
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qb * BQ;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const size_t q_stride = static_cast<size_t>(a.H) * HD;
  const size_t kv_stride = static_cast<size_t>(a.KV) * HD;
  const size_t q_base = (static_cast<size_t>(b) * a.S * a.H + h) * HD;
  const size_t kv_base = (static_cast<size_t>(b) * a.S * a.KV + kvh) * HD;

  for (int c = tid; c < BQ * (HD / VN); c += THREADS) {
    const int r = c / (HD / VN), dd = (c % (HD / VN)) * VN;
    float x[VN];
    if (q0 + r < a.S) {
      attn::load16(q + q_base + (q0 + r) * q_stride + dd, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) Qs[r * L::QST + dd + e] = x[e] * a.scale;
  }

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles_all = (a.S + BK - 1) / BK;
  const int n_tiles = CAUSAL ? min(n_tiles_all, (q0 + BQ - 1) / BK + 1)
                             : n_tiles_all;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    // ---- K/V tile -> fp32 shared memory (zeros past S)
    for (int c = tid; c < BK * (HD / VN); c += THREADS) {
      const int i = c / (HD / VN), dd = (c % (HD / VN)) * VN;
      float kf[VN], vf[VN];
      if (k0 + i < a.S) {
        const size_t off = kv_base + (k0 + i) * kv_stride + dd;
        attn::load16(k + off, kf);
        attn::load16(v + off, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        Ks[i * L::QST + dd + e] = kf[e];
        Vs[i * HD + dd + e] = vf[e];
      }
    }
    __syncthreads();
    // ---- scores S = Q K^T on the thread's 4 x 8 micro-tile
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(tr + 16 * i) * L::QST + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tc + 8 * j) * L::QST + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] += qv[i] * kv[j];
    }
    // ---- mask, online softmax (row shared by 8 neighbouring lanes)
    float alpha[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + tr + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tc + 8 * j;
        const bool ok = col < a.S && (!CAUSAL || col <= row);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], attn::group_max<8>(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = attn::exp_diff(s[i][j], m_new);
        sum += s[i][j];
      }
      alpha[i] = attn::exp_diff(m[i], m_new);
      l[i] = l[i] * alpha[i] + attn::group_sum<8>(sum);
      m[i] = m_new;
    }
    __syncthreads();                    // every thread is done with K
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        Ps[(tr + 16 * i) * L::PST + tc + 8 * j] = s[i][j];
    __syncthreads();
    // ---- acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha[i];
    const int n_keys = min(BK, a.S - k0);
#pragma unroll 2
    for (int t = 0; t < n_keys; ++t) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(tr + 16 * i) * L::PST + t];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[t * HD + tc + 8 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += pv[i] * vv[j];
    }
    __syncthreads();                    // before the next tile overwrites
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= a.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      out[q_base + row * q_stride + tc + 8 * j] =
          attn::from_f<T>(acc[i][j] * inv);
  }
}

struct Launch {
  FlashArgs a;
  int B, causal;
  cudaStream_t stream;

  template <typename T, int HD, bool CAUSAL>
  int run() const {
    using L = FlashSmem<HD>;
    auto kern = flash_fwd_kernel<T, HD, CAUSAL>;
    static bool configured = false;     // once per instantiation
    cudaError_t e;
    if (!configured) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::BYTES));
      if (e != cudaSuccess) return static_cast<int>(e);
      configured = true;
    }
    const dim3 grid((a.S + BQ - 1) / BQ, B * a.H);
    kern<<<grid, THREADS, L::BYTES, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }

  template <typename T, int HD>
  int operator()() const {
    return causal ? run<T, HD, true>() : run<T, HD, false>();
  }
};

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was taken).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* stream,
    int dtype, int B, int S, int H, int KV, int hd, int causal) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l;
  l.a = FlashArgs{q, k, v, out, S, H, KV,
                  1.0f / sqrtf(static_cast<float>(hd))};
  l.B = B;
  l.causal = causal;
  l.stream = static_cast<cudaStream_t>(stream);
  return dispatch_type_hd(dtype, hd, l);
}
