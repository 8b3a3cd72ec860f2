// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssm_scan_kernel in
// src/repro/kernels/ssm_scan/kernel.py (body _ssm_kernel).  The plain
// PyTorch version of the same function is ssm_scan_plain in
// src/repro_torch/kernels/ssm_scan.py, with the semantics of ssm_scan_ref:
// in fp32, h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t from h_0 = 0 and
// y_t = C_t . h_t, returning y and the final h.  Forward only: the JAX
// package has no backward for it.
//
// Layouts (all contiguous): dt, x (B, S, din) and Bt, Ct (B, S, ds), all
// four fp32 or all four bf16; A (din, ds) fp32; y (B, S, din) fp32;
// h (B, din, ds) fp32.
//
// What bounds it: bytes and exponentials, about equally.  Each call reads
// dt, x, B, C and A once and writes y and h once (at B=1, S=4096,
// din 8192, ds 16: 270 MB with bf16 inputs, 0.081 ms at 3.35 TB/s; 404 MB
// with fp32 inputs, 0.121 ms), and takes one exp per (step, channel,
// state) (537 M, about 0.13 ms through the SFUs at 16 a clock per SM).
// The recurrence is sequential in time but independent across channels and
// states, so the design keeps the time loop inside a block and spreads
// channels and states over the card.
//
// Design.  On the TPU the grid's last dimension runs time chunks in order
// on one core and carries h in VMEM between them; here blocks run in no
// order, so one block owns its channels for the whole sequence and loops
// over time itself, with h in registers.
// - Warps in flight.  At B=1 the only parallelism is din x ds.  A channel
//   gets LANES = 16 / NS lanes of NS states each (NS = 2: 8 lanes), a
//   block 128 threads = CH = 16 channels, so din 8192 gives 2,048 warps,
//   about 16 an SM (four lanes of four states gave 8).  The exps of a step
//   do not depend on h, only the fused multiply-add that carries h does,
//   so the LANES steps a lane unrolls overlap their exps.
// - y_t is a sum over the LANES lanes of a channel.  For LANES steps at a
//   time the lanes do a reduce-scatter (LANES - 1 shuffles for LANES
//   steps), after which lane g holds y of step g; it goes to a y tile in
//   shared memory, written to device memory row by row.
// - Staging.  Chunks of T = 64 steps of dt and x (T x CH) and of B and C
//   (T x 16) come through a ring of STAGES buffers in shared memory, filled
//   by cp.async 16-byte copies (zero-filled past S and din), the next
//   STAGES - 1 chunks in flight while one is computed.  A convert pass
//   turns the landed chunk, in its own dtype, into fp32 (dt, dt x) pairs
//   and (B, C) pairs, so a lane reads one 8-byte and one 16-byte word a
//   step.  A shape that cp.async cannot copy in 16-byte pieces (ds below
//   16, din not a multiple of 16 bytes, an unaligned pointer) fills the
//   same ring with ordinary loads instead.
// - exp(dt A) is exp2(dt A log2(e)) through ex2.approx (relative error
//   about 2^-22), A log2(e) taken once a lane.
// Steps past S read dt = x = B = C = 0, which leaves h unchanged
// (exp(0) = 1), so any S is taken; states past ds have A = B = C = 0;
// channels past din are masked, so any din is taken.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::to_f;

constexpr int DTYPE_F32 = 0;          // element codes passed by the wrapper
constexpr int DTYPE_BF16 = 1;
constexpr int DSP = 16;               // ds padded to 16
constexpr int NS = 2;                 // states per lane
constexpr int LANES = DSP / NS;       // lanes per channel
constexpr int THREADS = 128;
constexpr int CH = THREADS / LANES;   // channels per block
constexpr int T = 64;                 // time steps per staged chunk
constexpr int STAGES = 2;             // chunks in the cp.async ring
constexpr int YST = CH + 4;           // y tile row stride: the lanes of a
                                      // warp write LANES rows, 4 banks apart
constexpr unsigned FULL = 0xffffffffu;
static_assert(T % LANES == 0 && LANES <= 32 && 32 % LANES == 0, "lanes");

struct ScanArgs {
  const void* dt;
  const void* x;
  const void* Bt;
  const void* Ct;
  const float* A;
  float* y;
  float* h;
  int S, din, ds;
};

// One chunk as it lands, in the input dtype.
template <typename Tin>
struct Stage {
  alignas(16) Tin dt[T][CH];
  alignas(16) Tin x[T][CH];
  alignas(16) Tin B[T][DSP];
  alignas(16) Tin C[T][DSP];
};

template <typename Tin>
struct Smem {
  Stage<Tin> ring[STAGES];
  float2 dx[T][CH];                   // (dt, dt x) of a step and channel
  alignas(16) float2 bc[T][DSP];      // (B, C) of a step and state
  float y[T][YST];
};

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Fill ring stage st with the chunk at t0.  Async: 16-byte cp.async
// pieces (the wrapper checked the alignment); else ordinary loads.
template <typename Tin, bool Async>
__device__ __forceinline__ void load_chunk(Stage<Tin>& st, const ScanArgs& a,
                                           const Tin* dtg, const Tin* xg,
                                           const Tin* Bg, const Tin* Cg,
                                           int c0, int t0) {
  const int tid = threadIdx.x;
  if (Async) {
    constexpr int E = 16 / sizeof(Tin);         // elements a piece
    constexpr int PR = CH / E;                  // pieces a dt / x row
    for (int p = tid; p < T * PR; p += THREADS) {
      const int r = p / PR, e = (p % PR) * E, t = t0 + r;
      const bool ok = t < a.S && c0 + e < a.din;
      const size_t off = ok ? static_cast<size_t>(t) * a.din + c0 + e : 0;
      attn::cp_async16(&st.dt[r][e], dtg + off, ok ? 16 : 0);
      attn::cp_async16(&st.x[r][e], xg + off, ok ? 16 : 0);
    }
    // ds == 16: the chunk's B and C rows are one contiguous run
    for (int p = tid; p < T * DSP / E; p += THREADS) {
      const int e = p * E, t = t0 + e / DSP;
      const bool ok = t < a.S;
      const size_t off = ok ? static_cast<size_t>(t0) * DSP + e : 0;
      attn::cp_async16(&st.B[0][0] + e, Bg + off, ok ? 16 : 0);
      attn::cp_async16(&st.C[0][0] + e, Cg + off, ok ? 16 : 0);
    }
  } else {
    const Tin zero = Tin(0.f);
    for (int p = tid; p < T * CH; p += THREADS) {
      const int r = p / CH, c = p % CH, t = t0 + r;
      const bool ok = t < a.S && c0 + c < a.din;
      const size_t off = static_cast<size_t>(t) * a.din + c0 + c;
      st.dt[r][c] = ok ? dtg[off] : zero;
      st.x[r][c] = ok ? xg[off] : zero;
    }
    for (int p = tid; p < T * DSP; p += THREADS) {
      const int r = p / DSP, j = p % DSP, t = t0 + r;
      const bool ok = t < a.S && j < a.ds;
      const size_t off = static_cast<size_t>(t) * a.ds + j;
      st.B[r][j] = ok ? Bg[off] : zero;
      st.C[r][j] = ok ? Cg[off] : zero;
    }
  }
}

template <typename Tin, bool Async>
__global__ void __launch_bounds__(THREADS)
ssm_scan_fwd_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<Tin>& s = *reinterpret_cast<Smem<Tin>*>(smem_raw);
  const int tid = threadIdx.x;
  const int cl = tid / LANES, g = tid % LANES;
  const int b = blockIdx.y, c0 = blockIdx.x * CH, c = c0 + cl;
  const size_t row0 = static_cast<size_t>(b) * a.S;
  const Tin* dtg = static_cast<const Tin*>(a.dt) + row0 * a.din;
  const Tin* xg = static_cast<const Tin*>(a.x) + row0 * a.din;
  const Tin* Bg = static_cast<const Tin*>(a.Bt) + row0 * a.ds;
  const Tin* Cg = static_cast<const Tin*>(a.Ct) + row0 * a.ds;

  float A2[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int st = g * NS + j;
    A2[j] = (c < a.din && st < a.ds)
                ? a.A[static_cast<size_t>(c) * a.ds + st] * 1.4426950408889634f
                : 0.f;
    h[j] = 0.f;
  }

  const int chunks = (a.S + T - 1) / T;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < chunks)
      load_chunk<Tin, Async>(s.ring[k], a, dtg, xg, Bg, Cg, c0, k * T);
    attn::cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * T, next = k + STAGES - 1;
    if (next < chunks)
      load_chunk<Tin, Async>(s.ring[next % STAGES], a, dtg, xg, Bg, Cg, c0,
                             next * T);
    attn::cp_async_commit();
    attn::cp_async_wait<STAGES - 1>();  // chunk k has landed
    __syncthreads();

    // convert: (dt, dt x) and (B, C) pairs in fp32
    const Stage<Tin>& st = s.ring[k % STAGES];
    for (int p = tid; p < T * CH; p += THREADS) {
      const int r = p / CH, q = p % CH;
      const float d = to_f(st.dt[r][q]);
      s.dx[r][q] = make_float2(d, d * to_f(st.x[r][q]));
    }
    for (int p = tid; p < T * DSP; p += THREADS) {
      const int r = p / DSP, j = p % DSP;
      s.bc[r][j] = make_float2(to_f(st.B[r][j]), to_f(st.C[r][j]));
    }
    __syncthreads();

#pragma unroll 1
    for (int u = 0; u < T; u += LANES) {
      float part[LANES];              // this lane's share of y, LANES steps
#pragma unroll
      for (int q = 0; q < LANES; ++q) {
        const float2 ddx = s.dx[u + q][cl];
        float bc[2 * NS];
        if (NS == 1) {
          const float2 v = s.bc[u + q][g];
          bc[0] = v.x;
          bc[1] = v.y;
        } else {
#pragma unroll
          for (int j = 0; j < NS; j += 2) {
            const float4 v =
                *reinterpret_cast<const float4*>(&s.bc[u + q][g * NS + j]);
            bc[2 * j] = v.x;
            bc[2 * j + 1] = v.y;
            bc[2 * j + 2] = v.z;
            bc[2 * j + 3] = v.w;
          }
        }
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float decay = exp2_approx(ddx.x * A2[j]);
          h[j] = fmaf(decay, h[j], ddx.y * bc[2 * j]);
          acc = fmaf(h[j], bc[2 * j + 1], acc);
        }
        part[q] = acc;
      }
      // reduce-scatter over the channel's lanes: at width w, lanes g and
      // g ^ w swap halves of the steps they hold; lane g is left with the
      // sum for step u + g
#pragma unroll
      for (int w = LANES / 2; w >= 1; w /= 2) {
        const bool hi = g & w;
#pragma unroll
        for (int q = 0; q < w; ++q) {
          const float keep = hi ? part[q + w] : part[q];
          const float send = hi ? part[q] : part[q + w];
          part[q] = keep + __shfl_xor_sync(FULL, send, w);
        }
      }
      s.y[u + g][cl] = part[0];
    }
    __syncthreads();
    for (int p = tid; p < T * CH; p += THREADS) {
      const int r = p / CH, q = p % CH;
      if (t0 + r < a.S && c0 + q < a.din)
        a.y[(row0 + t0 + r) * a.din + c0 + q] = s.y[r][q];
    }
  }
  if (c < a.din) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int st = g * NS + j;
      if (st < a.ds)
        a.h[(static_cast<size_t>(b) * a.din + c) * a.ds + st] = h[j];
    }
  }
}

template <typename Tin, bool Async>
int run(const ScanArgs& a, int B, cudaStream_t stream) {
  const dim3 grid((a.din + CH - 1) / CH, B);
  const size_t smem = sizeof(Smem<Tin>);
  auto kernel = ssm_scan_fwd_kernel<Tin, Async>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int dispatch(const ScanArgs& a, int B, int aligned, cudaStream_t stream) {
  return aligned ? run<Tin, true>(a, B, stream) : run<Tin, false>(a, B, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was taken).
// ``aligned`` is 1 when ds == 16, din * element size is a multiple of 16
// bytes and dt, x, Bt, Ct are 16-byte aligned: the cp.async path.
extern "C" int ssm_scan_launch(const void* dt, const void* x, const void* Bt,
                               const void* Ct, const void* A, void* y,
                               void* h, void* stream, int dtype, int B,
                               int S, int din, int ds, int aligned) {
  if (B <= 0 || B > 65535 || S <= 0 || din <= 0 || ds <= 0 || ds > DSP)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{dt, x, Bt, Ct, static_cast<const float*>(A),
                   static_cast<float*>(y), static_cast<float*>(h), S, din,
                   ds};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return dispatch<float>(a, B, aligned, st);
  if (dtype == DTYPE_BF16) return dispatch<__nv_bfloat16>(a, B, aligned, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
