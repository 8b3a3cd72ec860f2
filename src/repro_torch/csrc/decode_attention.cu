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
// m and l (B*KV, n_splits, G), fp32; m in units of scaled scores.
//
// What bounds it: bytes.  Each key row is used by G query heads only, so a
// decode step does about 2 G flops per byte of cache it reads, far under
// the card's ratio of about 295 bf16 flops per byte.  The kernel's job is
// to read the valid prefix of the cache once and nothing past it, with
// enough bytes in flight, and to keep the math off the loads' path.
//
// Design.  One block of 4 warps per (batch, kv head, split); it streams
// only the keys below min(lengths[b], S) within its split, 64 keys a
// step.  Any S and any lengths in [1, S] are taken: the ragged edge is
// masked here, not by the caller's shape.  Then decode_merge_kernel
// combines the splits with the renormalized flash-decoding merge
// (kernel.py:108-114) and writes the output.  The split kernel has two
// versions, one per element type; the port's main path runs attention in
// bf16 only.
//
// decode_split_mma_kernel (bf16): the G <= 16 query heads of the group
// are the 16 rows of one mma tile (zero rows past G), kept bf16 and
// unscaled in registers as A fragments.  Warp w takes keys 16 w .. 16 w +
// 15 of every 64-key step, through its own three-stage ring of bf16 K/V
// slices in shared memory filled by cp.async (two slices in flight while
// one is computed; rows past the valid keys are zero-filled and masked),
// with one __syncwarp a stage and no __syncthreads in the loop.  Scores
// are mma.sync m16n8k16 in fp32, scaled there (folded with log2(e) into
// exp2f); each warp keeps its own online softmax on the fragments, and P
// goes from registers into the P V product as a bf16 pair hi + lo (one
// bf16 rounding of P misses the bf16 tolerance near cancelling outputs,
// tests/test_torch_attention_tiles.py).  At the end the four warps'
// (o, m, l) are merged in shared memory, reusing the ring.  About 106 KB
// of shared memory at hd 128: two blocks a SM, 16 stages of 8 KB in
// flight on a SM.  At hd 192 (12 k-steps, 24 output tiles a warp) a block
// holds 156 KB: one block a SM.
//
// decode_split_kernel (fp32, the fp32 model checks): the first SIMT
// version.  Each K/V tile of 64 keys is loaded into fp32 shared memory
// and shared by the G query heads; two threads per key compute the
// scores, one warp per head row takes the tile's max and sum, and each
// thread accumulates its (head row, dim) outputs of P V in registers (at
// hd 192, above the block's 128 threads, two dims a thread for the first
// 64 threads).
// It is compiled for G rounded up to a power of two (GP); the padding
// rows of Q are zeros whose results are dropped.
#include <type_traits>

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
  // P V ownership: up to 128 dims, thread tid owns dim tid % HD of NT
  // groups of head rows; above (hd 192), dims tid and tid + THREADS of
  // every head row
  static constexpr int NT = HD <= THREADS ? THREADS / HD : 1;
  static constexpr int DPT = (HD + THREADS - 1) / THREADS;  // dims a thread
  static constexpr int RPT = (GP + NT - 1) / NT;  // head rows per thread
  static constexpr int FLOATS =
      GP * HD + BK * KST + BK * HD + BK * GP + 3 * GP;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// ---- fp32: SIMT (instantiated for float only)

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

  // PV ownership: dims d + THREADS j (those below HD), head rows
  // [g0, g0 + RPT)
  const int d = tid % HD;
  const int g0 = (tid / HD) * L::RPT;
  float acc[L::RPT][L::DPT];
#pragma unroll
  for (int r = 0; r < L::RPT; ++r)
#pragma unroll
    for (int j = 0; j < L::DPT; ++j) acc[r][j] = 0.f;

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
#pragma unroll
        for (int j = 0; j < L::DPT; ++j)
          if (g0 + r < G) acc[r][j] *= alpha_s[g0 + r];
      for (int i = 0; i < n_valid; ++i) {
#pragma unroll
        for (int j = 0; j < L::DPT; ++j) {
          if (d + THREADS * j >= HD) break;
          const float vv = Vs[i * HD + d + THREADS * j];
#pragma unroll
          for (int r = 0; r < L::RPT; ++r)
            if (g0 + r < G) acc[r][j] += Ps[i * GP + g0 + r] * vv;
        }
      }
      __syncthreads();
    }
  }
  // ---- partial (o, m, l) of this split; an empty split leaves (0, -inf, 0)
#pragma unroll
  for (int r = 0; r < L::RPT; ++r)
#pragma unroll
    for (int j = 0; j < L::DPT; ++j)
      if (g0 + r < G && d + THREADS * j < HD)
        a.o_part[(part * G + g0 + r) * HD + d + THREADS * j] = acc[r][j];
  if (tid < G) {
    a.m_part[part * G + tid] = start < end ? m_s[tid] : -INFINITY;
    a.l_part[part * G + tid] = start < end ? l_s[tid] : 0.f;
  }
}

// ---- bf16: tensor cores

using bf16 = __nv_bfloat16;
constexpr int WARPS = THREADS / 32;
constexpr int WK = BK / WARPS;          // keys a warp takes of each step
constexpr int STAGES = 3;               // ring depth of each warp
constexpr int MROWS = 16;               // mma rows: the group's heads
static_assert(WK == 16, "one mma k-step of keys per warp and stage");

template <int HD>
struct MmaSmem {
  static constexpr int ST = HD + 8;     // row stride in elements: +16 bytes
  static constexpr int SLICE = WK * ST; // one K or V slice
  static constexpr int RING = STAGES * 2 * SLICE;   // one warp's ring
  // Q [MROWS][ST], then the warps' rings; the merge reuses the rings as
  // fp32 m [WARPS][MROWS], l [WARPS][MROWS], o [WARPS][MROWS][HD]
  static constexpr size_t BYTES = (MROWS * ST + WARPS * RING) * sizeof(bf16);
  static_assert(WARPS * MROWS * (HD + 2) * sizeof(float) <=
                WARPS * RING * sizeof(bf16), "merge scratch fits the rings");
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
decode_split_mma_kernel(const DecodeArgs a) {
  using L = MmaSmem<HD>;
  constexpr int ST = L::ST;
  constexpr int KS = HD / 16;           // k-steps of Q K^T
  constexpr int DT = HD / 8;            // 8-dim tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* rings = Qs + MROWS * ST;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = a.G;
  const int split = blockIdx.x;
  const int bh = blockIdx.y;            // b * KV + kv head
  const int b = bh / a.KV, kvh = bh % a.KV;
  const int len = min(a.lengths[b], a.S);
  const int start = split * a.split_len;
  const int end = min(start + a.split_len, len);
  const size_t part = static_cast<size_t>(bh) * a.n_splits + split;
  if (start >= end) {                   // an empty split: (0, -inf, 0)
    for (int i = tid; i < G * HD; i += THREADS)
      a.o_part[part * G * HD + i] = 0.f;
    if (tid < G) {
      a.m_part[part * G + tid] = -INFINITY;
      a.l_part[part * G + tid] = 0.f;
    }
    return;
  }

  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const size_t row_stride = static_cast<size_t>(a.KV) * HD;
  const size_t base = (static_cast<size_t>(b) * a.S * a.KV + kvh) * HD;
  bf16* ring = rings + warp * L::RING;
  const int n_steps = (end - start + BK - 1) / BK;
  auto load = [&](int it) {             // this warp's slice of step it
    const int k0 = start + it * BK + warp * WK;
    const int n_valid = end - k0;
    if (n_valid <= 0) return;           // not computed either
    const size_t off = base + static_cast<size_t>(k0) * row_stride;
    bf16* kd = ring + (it % STAGES) * 2 * L::SLICE;
    attn::cp_async_rows<HD, ST>(kd, k + off, row_stride, WK, n_valid, lane,
                                32);
    attn::cp_async_rows<HD, ST>(kd + L::SLICE, v + off, row_stride, WK,
                                n_valid, lane, 32);
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < n_steps) load(it);
    attn::cp_async_commit();
  }

  // the group's query rows, zeros past G
  const bf16* q = static_cast<const bf16*>(a.q) +
                  static_cast<size_t>(bh) * G * HD;
  for (int c = tid; c < MROWS * (HD / 8); c += THREADS) {
    const int r = c / (HD / 8), e = (c % (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(Qs + r * ST + e) =
        r < G ? *reinterpret_cast<const uint4*>(q + r * HD + e)
              : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  const int lr = lane % 8 + 8 * ((lane / 8) % 2), lc = 8 * (lane / 16);
  const int kr = lane % 8 + 8 * (lane / 16), kc = 8 * ((lane / 8) % 2);
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    attn::ldmatrix_x4(qf[ks], Qs + lr * ST + ks * 16 + lc);

  const float sl2 = a.scale * 1.4426950408889634f;
  float acc[DT][4], m[2], l[2];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = -INFINITY;                   // rows g and g + 8, raw scores
    l[r] = 0.f;                         // this lane's part of the row sum
  }

  for (int it = 0; it < n_steps; ++it) {
    attn::cp_async_wait<STAGES - 2>();
    __syncwarp();                       // step it landed; it - 1 is free
    if (it + STAGES - 1 < n_steps) load(it + STAGES - 1);
    attn::cp_async_commit();
    const int k0 = start + it * BK + warp * WK;
    if (k0 >= end) continue;            // this warp's keys are all past end
    const bf16* kd = ring + (it % STAGES) * 2 * L::SLICE;
    const bf16* vd = kd + L::SLICE;

    // ---- scores of 16 keys, fp32
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kb[4];
      attn::ldmatrix_x4(kb, kd + kr * ST + ks * 16 + kc);
      attn::mma_bf16(s[0], qf[ks], kb[0], kb[1]);
      attn::mma_bf16(s[1], qf[ks], kb[2], kb[3]);
    }
    if (k0 + WK > end) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= end) s[j][e] = -INFINITY;
    }
    // ---- online softmax on the fragments
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                             fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      const float m_new = fmaxf(m[r], attn::group_max<4>(mx));
      const float off = attn::exp2_offset(m_new, sl2);
      alpha[r] = exp2f(fmaf(m[r], sl2, -off));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], sl2, -off));
          sum += s[j][e];
        }
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
    // ---- acc = acc * alpha + P V, P as bf16 hi + lo from registers
    uint32_t ph[4], pl[4];
    attn::split_bf16x2(s[0][0], s[0][1], ph[0], pl[0]);
    attn::split_bf16x2(s[0][2], s[0][3], ph[1], pl[1]);
    attn::split_bf16x2(s[1][0], s[1][1], ph[2], pl[2]);
    attn::split_bf16x2(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * dp][e] *= alpha[e >> 1];
        acc[2 * dp + 1][e] *= alpha[e >> 1];
      }
      uint32_t vb[4];
      attn::ldmatrix_x4_trans(vb, vd + lr * ST + dp * 16 + lc);
      attn::mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
      attn::mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
      attn::mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
      attn::mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
    }
  }

  // ---- merge the four warps' (o, m, l) in shared memory -> the partial
  attn::cp_async_wait<0>();
  __syncthreads();                      // every warp is done with its ring
  float* m_w = reinterpret_cast<float*>(rings);   // [WARPS][MROWS], scaled
  float* l_w = m_w + WARPS * MROWS;               // [WARPS][MROWS]
  float* o_w = l_w + WARPS * MROWS;               // [WARPS][MROWS][HD]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * MROWS + g + 8 * r;
    const float l_row = attn::group_sum<4>(l[r]);
    if (t == 0) {
      m_w[row] = m[r] == -INFINITY ? -INFINITY : m[r] * a.scale;
      l_w[row] = l_row;
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(o_w + row * HD + 8 * d + 2 * t) =
          make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float m_max = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m_max = fmaxf(m_max, m_w[w * MROWS + r]);
    float o = 0.f, l_tot = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float alpha = attn::exp_diff(m_w[w * MROWS + r], m_max);
      o += o_w[(w * MROWS + r) * HD + d] * alpha;
      l_tot += l_w[w * MROWS + r] * alpha;
    }
    a.o_part[(part * G + r) * HD + d] = o;
    if (d == 0) {
      a.m_part[part * G + r] = m_max;
      a.l_part[part * G + r] = l_tot;
    }
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

  template <typename K>
  int split(K kern, size_t bytes, bool& configured) const {
    cudaError_t e;
    if (!configured) {                  // once per instantiation
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
      configured = true;
    }
    kern<<<dim3(a.n_splits, B * a.KV), THREADS, bytes, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }

  template <int HD, int GP>
  int run_f32() const {
    static bool configured = false;
    return split(decode_split_kernel<float, HD, GP>,
                 DecodeSmem<HD, GP>::BYTES, configured);
  }

  // fp32 takes the SIMT split kernel, bf16 the tensor-core one
  template <typename T, int HD>
  int operator()() const {
    int e = static_cast<int>(cudaErrorInvalidValue);
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      static bool configured = false;
      if (G <= MROWS)
        e = split(decode_split_mma_kernel<HD>, MmaSmem<HD>::BYTES,
                  configured);
    } else if (G <= 1) {
      e = run_f32<HD, 1>();
    } else if (G <= 2) {
      e = run_f32<HD, 2>();
    } else if (G <= 4) {
      e = run_f32<HD, 4>();
    } else if (G <= 8) {
      e = run_f32<HD, 8>();
    } else if (G <= 16) {
      e = run_f32<HD, 16>();
    }
    if (e != 0) return e;
    decode_merge_kernel<T, HD><<<B * a.KV * G, HD, 0, stream>>>(a, G);
    return static_cast<int>(cudaGetLastError());
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
