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
// the cost, and it belongs on the tensor cores.
//
// Design.  Two kernels, one per element type; the port's main path runs
// attention in bf16 only.
//
// flash_fwd_mma_kernel (bf16): one block of 4 warps per (batch, query
// head, 64-query tile), 16 query rows a warp; the grid runs the tiles
// nearest the diagonal's end first.  Q stays bf16 as given: it is copied
// into shared memory once and held in registers as mma A fragments
// (ldmatrix).  K/V tiles of 64 keys stay bf16 in a two-stage shared ring
// filled by cp.async, tile j + 1 in flight while tile j is computed, one
// __syncthreads a tile; keys past S are zero-filled and masked.  Rows are
// padded by 16 bytes, so the 8 row addresses of an ldmatrix fall on 8
// different bank groups (a 256-byte row at hd 128 would put them on one).
// S = Q K^T is mma.sync m16n8k16 in fp32 registers; the scale is applied
// to the fp32 scores, folded with log2(e) into exp2f (a scaled bf16 Q
// would add a rounding the oracle does not have).  The online softmax
// works on the accumulator fragments: a row's max is two shuffles in a
// quad, its sum is reduced once at the end, each exp is one FFMA and one
// exp2f.  The causal mask is applied on the diagonal tile only, and tiles
// past it are not visited.  P goes from the score fragments straight into
// A fragments, in registers, as a bf16 pair hi + lo: one bf16 rounding of
// P misses the bf16 tolerance near cancelling outputs
// (tests/test_torch_attention_tiles.py), so P V takes two products per
// step (V through ldmatrix.trans), the hi ones first so that the two
// products into one accumulator are not back to back.  The epilogue
// divides by max(l, 1e-30) and stores the rows below S.  At hd 128 a block
// holds 85 KB of shared memory and about 210 registers a thread: two
// blocks, 8 warps, a SM.  At hd 192 (12 k-steps, 24 output tiles a warp)
// a block holds 125 KB: one block a SM.  (Blocks of 8 warps and 128 queries, which halve
// the K/V bytes a flop draws from L2, measured no faster.)
//
// flash_fwd_kernel (fp32, the fp32 model checks): the first SIMT version.
// Thread (tr, tc) = (tid / 8, tid % 8) owns query rows tr + 16 i (i < 4)
// in both products: key columns tc + 8 j (j < 8) of the scores and dims
// tc + 8 j (j < hd / 8) of the output, so a row's max and sum are a
// shuffle among 8 neighbouring lanes.  Scaled Q, K and V are fp32 in
// shared memory, P reuses the K tile's place (145 KB at hd 192).
#include <type_traits>

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

// ---- fp32: SIMT (instantiated for float only)

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

// ---- bf16: tensor cores

using bf16 = __nv_bfloat16;

static_assert(THREADS / 32 * 16 == BQ, "16 query rows a warp");

template <int HD>
struct MmaSmem {
  static constexpr int ST = HD + 8;     // row stride in elements: +16 bytes
  // Q [BQ][ST], then K [2][BK][ST], then V [2][BK][ST]
  static constexpr size_t BYTES = (BQ + 4 * BK) * ST * sizeof(bf16);
};

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_mma_kernel(const FlashArgs a) {
  constexpr int ST = MmaSmem<HD>::ST;
  constexpr int KS = HD / 16;           // k-steps of Q K^T
  constexpr int NT = BK / 8;            // 8-key tiles of the scores
  constexpr int DT = HD / 8;            // 8-dim tiles of the output
  constexpr int VP = HD >= 32 ? 2 : 1;  // 16-dim V blocks per ldmatrix round
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * ST;
  bf16* Vs = Ks + 2 * BK * ST;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;            // b * H + h
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qb * BQ;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const size_t q_stride = static_cast<size_t>(a.H) * HD;
  const size_t kv_stride = static_cast<size_t>(a.KV) * HD;
  const size_t q_base = (static_cast<size_t>(b) * a.S * a.H + h) * HD;
  const size_t kv_base = (static_cast<size_t>(b) * a.S * a.KV + kvh) * HD;
  const int n_tiles_all = (a.S + BK - 1) / BK;
  const int n_tiles = CAUSAL ? min(n_tiles_all, (q0 + BQ - 1) / BK + 1)
                             : n_tiles_all;

  auto load_kv = [&](int kt) {
    const int k0 = kt * BK;
    const size_t off = kv_base + static_cast<size_t>(k0) * kv_stride;
    const int slot = (kt & 1) * BK * ST;
    attn::cp_async_rows<HD, ST>(Ks + slot, k + off, kv_stride, BK,
                                a.S - k0, tid, THREADS);
    attn::cp_async_rows<HD, ST>(Vs + slot, v + off, kv_stride, BK,
                                a.S - k0, tid, THREADS);
  };
  attn::cp_async_rows<HD, ST>(Qs, q + q_base + q0 * q_stride, q_stride, BQ,
                              a.S - q0, tid, THREADS);
  load_kv(0);
  attn::cp_async_commit();

  // ldmatrix row and column of this lane: A operands and V (.trans) take
  // rows lr, columns lc of a 16 x 16 block; K (B operand) rows kr, kc
  const int lr = lane % 8 + 8 * ((lane / 8) % 2), lc = 8 * (lane / 16);
  const int kr = lane % 8 + 8 * (lane / 16), kc = 8 * ((lane / 8) % 2);
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const float sl2 = a.scale * 1.4426950408889634f;
  uint32_t qf[KS][4];
  float acc[DT][4], m[2], l[2];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;                         // this lane's part of the row sum
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    attn::cp_async_wait<0>();
    __syncthreads();                    // tile kt landed; kt - 1 is free
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        attn::ldmatrix_x4(qf[ks], Qs + (warp * 16 + lr) * ST + ks * 16 + lc);
    }
    if (kt + 1 < n_tiles) load_kv(kt + 1);
    attn::cp_async_commit();
    const int k0 = kt * BK;
    const bf16* kt_s = Ks + (kt & 1) * BK * ST;
    const bf16* vt_s = Vs + (kt & 1) * BK * ST;

    // ---- S = Q K^T, fp32
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        attn::ldmatrix_x4(kb, kt_s + (np * 16 + kr) * ST + ks * 16 + kc);
        attn::mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        attn::mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    // ---- masks: keys past S, and past the diagonal on its tile
    if (k0 + BK > a.S || (CAUSAL && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (col >= a.S || (CAUSAL && col > row)) s[j][e] = -INFINITY;
        }
    }
    // ---- online softmax on the fragments
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m[r], attn::group_max<4>(mx));
      const float off = attn::exp2_offset(m_new, sl2);
      alpha[r] = exp2f(fmaf(m[r], sl2, -off));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], sl2, -off));
          sum += s[j][e];
        }
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }
    // ---- acc += P V, P as bf16 hi + lo from registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      attn::split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      attn::split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      attn::split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      attn::split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      // VP blocks of 16 dims a round: hi products, then lo, so that the
      // two products into one accumulator are not back to back
#pragma unroll
      for (int dp = 0; dp < HD / 16; dp += VP) {
        uint32_t vb[VP][4];
#pragma unroll
        for (int i = 0; i < VP; ++i)
          attn::ldmatrix_x4_trans(
              vb[i], vt_s + (kk * 16 + lr) * ST + (dp + i) * 16 + lc);
#pragma unroll
        for (int i = 0; i < VP; ++i) {
          attn::mma_bf16(acc[2 * (dp + i)], ph, vb[i][0], vb[i][1]);
          attn::mma_bf16(acc[2 * (dp + i) + 1], ph, vb[i][2], vb[i][3]);
        }
#pragma unroll
        for (int i = 0; i < VP; ++i) {
          attn::mma_bf16(acc[2 * (dp + i)], pl, vb[i][0], vb[i][1]);
          attn::mma_bf16(acc[2 * (dp + i) + 1], pl, vb[i][2], vb[i][3]);
        }
      }
    }
  }

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / fmaxf(attn::group_sum<4>(l[r]), 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= a.S) continue;
    bf16* o = out + q_base + row * q_stride + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * d) = __floats2bfloat162_rn(
          acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
  }
}

struct Launch {
  FlashArgs a;
  int B, causal;
  cudaStream_t stream;

  // fp32 takes the SIMT kernel, bf16 the tensor-core kernel
  template <typename T, int HD, bool CAUSAL>
  int run() const {
    constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
    auto kern = MMA ? flash_fwd_mma_kernel<HD, CAUSAL>
                    : flash_fwd_kernel<float, HD, CAUSAL>;
    constexpr size_t bytes = MMA ? MmaSmem<HD>::BYTES : FlashSmem<HD>::BYTES;
    static bool configured = false;     // once per instantiation
    cudaError_t e;
    if (!configured) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
      configured = true;
    }
    const dim3 grid((a.S + BQ - 1) / BQ, B * a.H);
    kern<<<grid, THREADS, bytes, stream>>>(a);
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
