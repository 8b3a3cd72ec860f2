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
// din 8192, ds 16 in fp32: 404 MB, 0.121 ms at 3.35 TB/s), and takes one
// exp per (step, channel, state) (537 M, about 0.13 ms through the SFUs at
// 16 a clock per SM).  The recurrence is sequential in time but
// independent across channels and states, so the design keeps the time
// loop inside a block and spreads channels and states over the card.
//
// Design.  On the TPU the grid's last dimension runs time chunks in order
// on one core and carries h in VMEM between them; here blocks run in no
// order, so one block owns its channels for the whole sequence and loops
// over time itself, with h in registers.  A block holds 32 channels of one
// batch row, four lanes per channel, each lane 4 states (ds <= 16);
// states past ds have A = B = C = 0 and stay 0.  Four lanes
// a channel, not one thread a channel: at B=1 and din 8192 one thread a
// channel would be 256 warps for 132 SMs; four lanes make it 1,024 warps,
// while a lane still holds enough states for a step's exps to overlap.
// Chunks of 64 steps of dt and x (64 x 32) and of B and C (64 x ds) are
// staged in shared memory, converted to fp32 once; the next chunk's loads
// are issued into registers before the current chunk is computed, so they
// are in flight during it.  y_t needs a sum over the four lanes of a
// channel: for four steps at a time the lanes do a reduce-scatter (three
// shuffles for four steps, not two a step), after which lane g holds y of
// step g, writes it to a y tile in shared memory, and the tile is written
// to device memory row by row.  Steps past S read dt = x = B = C = 0,
// which leaves h unchanged (exp(0) = 1), so any S is taken; channels past
// din are masked, so any din is taken.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DTYPE_F32 = 0;          // element codes passed by the wrapper
constexpr int DTYPE_BF16 = 1;
constexpr int CH = 32;                // channels per block
constexpr int LANES = 4;              // lanes per channel
constexpr int NS = 4;                 // states per lane
constexpr int DSP = LANES * NS;       // ds padded to 16
constexpr int THREADS = CH * LANES;   // 128
constexpr int T = 64;                 // time steps per staged chunk
constexpr int XROWS = THREADS / CH;   // rows of a dt/x tile a pass loads
constexpr int YST = CH + 8;           // y tile row stride: the four lanes of
                                      // a channel write four rows, 8 banks
                                      // apart
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// NS consecutive floats of a B or C row, aligned to NS floats.
__device__ __forceinline__ void load_states(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

struct Tiles {
  float dt[T][CH];
  float x[T][CH];
  float y[T][YST];
  alignas(16) float B[T][DSP];
  alignas(16) float C[T][DSP];
};

// One chunk's share of this thread, held in registers between its loads
// from device memory and its store to shared memory.
template <typename Tin>
struct Staged {
  static constexpr int NX = T * CH / THREADS;                    // 16
  static constexpr int NB = (T * DSP + THREADS - 1) / THREADS;
  float dt[NX], x[NX], B[NB], C[NB];

  // Load the chunk at t0.  Steps past S and channels past din read 0.
  __device__ __forceinline__ void fetch(const ScanArgs& a, const Tin* dtg,
                                        const Tin* xg, const Tin* Bg,
                                        const Tin* Cg, int c0, int t0) {
    const int tid = threadIdx.x, col = c0 + tid % CH;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int t = t0 + tid / CH + i * XROWS;
      const bool ok = t < a.S && col < a.din;
      const size_t off = static_cast<size_t>(t) * a.din + col;
      dt[i] = ok ? to_f(dtg[off]) : 0.f;
      x[i] = ok ? to_f(xg[off]) : 0.f;
    }
    const int n = min(T, a.S - t0) * a.ds;   // valid B/C entries
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = tid + i * THREADS;
      const size_t off = static_cast<size_t>(t0) * a.ds + e;
      B[i] = e < n ? to_f(Bg[off]) : 0.f;
      C[i] = e < n ? to_f(Cg[off]) : 0.f;
    }
  }

  __device__ __forceinline__ void stash(Tiles& s, int ds) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      s.dt[tid / CH + i * XROWS][tid % CH] = dt[i];
      s.x[tid / CH + i * XROWS][tid % CH] = x[i];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = tid + i * THREADS;
      if (e < T * ds) {
        s.B[e / ds][e % ds] = B[i];
        s.C[e / ds][e % ds] = C[i];
      }
    }
  }
};

template <typename Tin>
__global__ void __launch_bounds__(THREADS)
ssm_scan_fwd_kernel(const ScanArgs a) {
  __shared__ Tiles s;
  const int tid = threadIdx.x;
  const int cl = tid / LANES, g = tid % LANES;
  const int b = blockIdx.y, c0 = blockIdx.x * CH, c = c0 + cl;
  const size_t row0 = static_cast<size_t>(b) * a.S;
  const Tin* dtg = static_cast<const Tin*>(a.dt) + row0 * a.din;
  const Tin* xg = static_cast<const Tin*>(a.x) + row0 * a.din;
  const Tin* Bg = static_cast<const Tin*>(a.Bt) + row0 * a.ds;
  const Tin* Cg = static_cast<const Tin*>(a.Ct) + row0 * a.ds;

  float A[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int st = g * NS + j;
    A[j] = (c < a.din && st < a.ds) ? a.A[static_cast<size_t>(c) * a.ds + st]
                                    : 0.f;
    h[j] = 0.f;
  }
  // the padding states' columns of the B and C tiles stay 0
  for (int e = tid; e < T * DSP; e += THREADS) {
    (&s.B[0][0])[e] = 0.f;
    (&s.C[0][0])[e] = 0.f;
  }

  Staged<Tin> next;
  next.fetch(a, dtg, xg, Bg, Cg, c0, 0);
  const int chunks = (a.S + T - 1) / T;
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * T;
    __syncthreads();                  // the last chunk's tiles are read
    next.stash(s, a.ds);
    __syncthreads();
    if (k + 1 < chunks) next.fetch(a, dtg, xg, Bg, Cg, c0, t0 + T);

#pragma unroll 1
    for (int u = 0; u < T; u += LANES) {
      float part[LANES];              // this lane's share of y, 4 steps
#pragma unroll
      for (int q = 0; q < LANES; ++q) {
        const int t = u + q;
        const float d = s.dt[t][cl];
        const float dx = d * s.x[t][cl];
        float Bv[NS], Cv[NS];
        load_states(&s.B[t][g * NS], Bv);
        load_states(&s.C[t][g * NS], Cv);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          h[j] = expf(d * A[j]) * h[j] + dx * Bv[j];
          acc += h[j] * Cv[j];
        }
        part[q] = acc;
      }
      // reduce-scatter over the channel's 4 lanes: lanes g and g ^ 2
      // swap halves (steps 0-1 / 2-3), then g and g ^ 1 swap quarters;
      // lane g is left with the sum for step u + g
      const bool hi2 = g & 2, hi1 = g & 1;
      float k0 = hi2 ? part[2] : part[0];
      float k1 = hi2 ? part[3] : part[1];
      k0 += __shfl_xor_sync(FULL, hi2 ? part[0] : part[2], 2);
      k1 += __shfl_xor_sync(FULL, hi2 ? part[1] : part[3], 2);
      const float yv = (hi1 ? k1 : k0) +
                       __shfl_xor_sync(FULL, hi1 ? k0 : k1, 1);
      s.y[u + g][cl] = yv;
    }
    __syncthreads();
    const int col = c0 + tid % CH;
#pragma unroll
    for (int i = 0; i < Staged<Tin>::NX; ++i) {
      const int r = tid / CH + i * XROWS;
      if (t0 + r < a.S && col < a.din)
        a.y[(row0 + t0 + r) * a.din + col] = s.y[r][tid % CH];
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

template <typename Tin>
int run(const ScanArgs& a, int B, cudaStream_t stream) {
  const dim3 grid((a.din + CH - 1) / CH, B);
  ssm_scan_fwd_kernel<Tin><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was taken).
extern "C" int ssm_scan_launch(const void* dt, const void* x, const void* Bt,
                               const void* Ct, const void* A, void* y,
                               void* h, void* stream, int dtype, int B,
                               int S, int din, int ds) {
  if (B <= 0 || B > 65535 || S <= 0 || din <= 0 || ds <= 0 || ds > DSP)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{dt, x, Bt, Ct, static_cast<const float*>(A),
                   static_cast<float*>(y), static_cast<float*>(h), S, din,
                   ds};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return run<float>(a, B, st);
  if (dtype == DTYPE_BF16) return run<__nv_bfloat16>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
