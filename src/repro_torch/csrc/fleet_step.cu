// Fleet opcode chunk stepper for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel make_pallas_chunk_fn in
// src/repro/kernels/fleet_step.py, whose per-op body is
// repro.fleet.jaxexec._apply_opcode_one (with _op_prologue and
// _advance_one).  It advances every queue instance's Stats-only state
// through one chunk of plan steps; the plain PyTorch version of the same
// function is fleet_step_plain in src/repro_torch/kernels/fleet_step.py,
// and the two must agree bit for bit on every state tensor.
//
// Design.  One thread per instance, 128 threads per block.  Each block
// copies both programs' opcode tables and base-count vectors (a few
// hundred int32) into shared memory once; every thread then loops over the
// chunk's ops and runs the program whose code matches its op kind.  The
// work is integer, branchy and scatter-heavy, with per-instance control
// flow (bail, epoch advance, row kinds), so there is no tile to give to
// Triton or the tensor cores.  A thread whose instance is inactive does
// nothing, which is what the reference's masked commit (jnp.where(m, ...))
// amounts to: every state change there is under the mask except the bail
// itself.  State is updated in place, as input_output_aliases does in the
// Pallas version.
//
// What bounds it: bytes.  It does no floating-point work.  Each instance's
// scalars, counts and kinds column are read and written once per chunk,
// plus the 32-byte sectors of the line planes, ring, stacks and limbo that
// the chunk's ops reach.  What holds this design back: the state is
// instance-major ([N, X]), so neighbouring threads touch addresses a whole
// row apart and the 2-D state accesses are not coalesced; only the
// scalars and the [C, N] kinds are.  Transposing the 2-D state to [X, N]
// is the next step.
//
// Index safety.  JAX clamps out-of-range gathers and drops out-of-range
// scatters; this kernel instead checks every computed index (line,
// volatile word, ring / free-stack / limbo position, slot, env symbol)
// and, on one out of range, sets a bit of the caller's error word and
// stops stepping that instance.  The wrapper reads the word at every poll
// and raises.  C's / and % truncate where Python's floor; every dividend
// is checked to be non-negative first, where the two agree.
//
// Limbo compaction.  The reference permutes the limbo ring by
// argsort(where(keep, 0, 1), stable=True): kept entries in order, then the
// freed ones in order, then the tail beyond nlimbo.  Limbo epochs never
// decrease along the ring (entries are appended with the current epoch and
// compaction keeps order), so the freed entries are a prefix and the
// permutation is a left rotation of [0, nlimbo) by the freed count, done in
// place with three reversals.  A freed set that is not a prefix sets
// ERR_LIMBO instead.

#include <cuda_runtime.h>
#include <stdint.h>

#define LINE_WORDS 8
#define N_EV 12
#define N_SYM 9
#define EPOCH_ADV_OPS 64
#define MAX_SLOT_GUARDS 4
#define BLOCK 128

enum { EV_HIT = 7, EV_DRAM = 8, EV_COLD_DRAM = 9, EV_COLD_NVM = 10,
       EV_POSTFLUSH = 11 };
enum { OPC_NOP = 0, OPC_CLASS_P = 1, OPC_CLASS_V = 2, OPC_ST_INVAL = 3,
       OPC_ST_EVERFL = 4, OPC_RECACHE = 5, OPC_LIMBO = 6, OPC_SLOT = 7,
       OPC_PDISCARD = 8, OPC_PADD = 9 };
enum { KIND_ENQ = 0, KIND_DEQ = 1 };
enum { S_NEW_P = 0, S_NEW_V = 1, S_TAIL_P = 2, S_TAIL_V = 3, S_HEAD_P = 4,
       S_HEAD_V = 5, S_NEXT_P = 6, S_NEXT_V = 7, S_PREV = 8 };
// error-word bits, as in src/repro_torch/kernels/fleet_step.py
enum { ERR_LINE = 1, ERR_VWORD = 2, ERR_RING = 4, ERR_FREE = 8,
       ERR_LIMBO = 16, ERR_SLOT = 32, ERR_OPCODE = 64, ERR_PERSISTED = 128 };

struct FsProg {
  int code, uses_ssmem, allocs_p, allocs_v, tail_guard, n_slot_guards;
  int slot_guard[MAX_SLOT_GUARDS];
  int prev_slot;                  // slot column bound to env "prev" (-1)
  int n_micro, n_rows;            // rows [0, n_micro) precede the FIFO update
  int table_off, base_off;        // offsets into the packed constants
};

// Field order matches _Args in src/repro_torch/kernels/fleet_step.py.
struct FsArgs {
  void *cached, *finval, *everfl, *persisted, *vtouched;
  void *ring_p, *ring_v, *free_p, *vfree, *limbo_a, *limbo_e, *limbo_k;
  void *counts, *slots;
  void *head, *length, *dummy_p, *dummy_v, *nfree, *cursor, *nvfree,
       *vcursor, *nlimbo, *epoch, *opsctr, *active, *bail_at;
  void *kinds, *consts, *err, *stream;
  int n, n_ops, start;
  int nl, npers, nvw, cap, fcap, vfcap, lcap, nslots;
  int area_base, area_cap, chunk_base, chunk_cap, node_words;
  int n_consts, n_progs;
  FsProg prog[2];
};

template <typename T>
__device__ __forceinline__ void reverse(T* a, int lo, int hi) {
  for (--hi; lo < hi; ++lo, --hi) {
    T t = a[lo];
    a[lo] = a[hi];
    a[hi] = t;
  }
}

template <typename T>
__device__ __forceinline__ void rotate_left(T* a, int n, int k) {
  reverse(a, 0, k);
  reverse(a, k, n);
  reverse(a, 0, n);
}

__device__ __forceinline__ int sym_value(int s, const int* env) {
  // env lives in registers: a switch keeps the index static
  switch (s) {
    case S_NEW_P: return env[S_NEW_P];
    case S_NEW_V: return env[S_NEW_V];
    case S_TAIL_P: return env[S_TAIL_P];
    case S_TAIL_V: return env[S_TAIL_V];
    case S_HEAD_P: return env[S_HEAD_P];
    case S_HEAD_V: return env[S_HEAD_V];
    case S_NEXT_P: return env[S_NEXT_P];
    case S_NEXT_V: return env[S_NEXT_V];
    default: return env[S_PREV];
  }
}

__global__ void __launch_bounds__(BLOCK) fleet_step_kernel(const FsArgs A) {
  extern __shared__ int sm[];
  const int* consts = static_cast<const int*>(A.consts);
  for (int t = threadIdx.x; t < A.n_consts; t += blockDim.x) sm[t] = consts[t];
  __syncthreads();

  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= A.n) return;
  const int64_t n = A.n;

  uint8_t* cached = static_cast<uint8_t*>(A.cached) + i * A.nl;
  uint8_t* finval = static_cast<uint8_t*>(A.finval) + i * A.nl;
  uint8_t* everfl = static_cast<uint8_t*>(A.everfl) + i * A.nl;
  uint8_t* persisted = static_cast<uint8_t*>(A.persisted) + i * A.npers;
  uint8_t* vtouched = static_cast<uint8_t*>(A.vtouched) + i * A.nvw;
  int* ring_p = static_cast<int*>(A.ring_p) + i * A.cap;
  int* ring_v = static_cast<int*>(A.ring_v) + i * A.cap;
  int* free_p = static_cast<int*>(A.free_p) + i * A.fcap;
  int* vfree = static_cast<int*>(A.vfree) + i * A.vfcap;
  int* limbo_a = static_cast<int*>(A.limbo_a) + i * A.lcap;
  int* limbo_e = static_cast<int*>(A.limbo_e) + i * A.lcap;
  uint8_t* limbo_k = static_cast<uint8_t*>(A.limbo_k) + i * A.lcap;
  int* counts = static_cast<int*>(A.counts) + i * N_EV;
  int* slots = static_cast<int*>(A.slots) + i * A.nslots;
  const uint8_t* kinds = static_cast<const uint8_t*>(A.kinds);

  int head = static_cast<int*>(A.head)[i];
  int length = static_cast<int*>(A.length)[i];
  int dummy_p = static_cast<int*>(A.dummy_p)[i];
  int dummy_v = static_cast<int*>(A.dummy_v)[i];
  int nfree = static_cast<int*>(A.nfree)[i];
  int cursor = static_cast<int*>(A.cursor)[i];
  int nvfree = static_cast<int*>(A.nvfree)[i];
  int vcursor = static_cast<int*>(A.vcursor)[i];
  int nlimbo = static_cast<int*>(A.nlimbo)[i];
  int epoch = static_cast<int*>(A.epoch)[i];
  int opsctr = static_cast<int*>(A.opsctr)[i];
  bool active = static_cast<uint8_t*>(A.active)[i] != 0;
  int bail_at = static_cast<int*>(A.bail_at)[i];
  int err = 0;

#define FAIL(bit) do { err |= (bit); goto done; } while (0)

  for (int c = 0; c < A.n_ops && active; ++c) {
    const int k = kinds[static_cast<int64_t>(c) * n + i];
    int pi = -1;
    for (int q = 0; q < A.n_progs; ++q)
      if (A.prog[q].code == k) { pi = q; break; }
    if (pi < 0) continue;
    const FsProg& P = A.prog[pi];
    const int oi = A.start + c;

    // ---- 1. tail record ---------------------------------------------------
    const int hl = head + max(length - 1, 0);
    if (hl < 0) FAIL(ERR_RING);
    const int tpos = hl % A.cap;
    const int tail_p = length > 0 ? ring_p[tpos] : dummy_p;
    const int tail_v = length > 0 ? ring_v[tpos] : dummy_v;

    // ---- 2. bail checks, in _op_prologue's order --------------------------
    bool bail = false;
    if (P.code == KIND_DEQ) bail |= length == 0;
    for (int g = 0; g < P.n_slot_guards; ++g) {
      const int s = P.slot_guard[g];
      if (s < 0 || s >= A.nslots) FAIL(ERR_SLOT);
      bail |= slots[s] == 0;
    }
    if (P.tail_guard) {
      if (tail_p < 0 || tail_p / LINE_WORDS >= A.npers) FAIL(ERR_PERSISTED);
      bail |= persisted[tail_p / LINE_WORDS] == 0;
    }
    if (P.allocs_p) bail |= nfree == 0 && cursor >= A.area_cap;
    if (P.allocs_v) bail |= nvfree == 0 && vcursor >= A.chunk_cap;
    if (bail) {
      bail_at = oi;
      active = false;
      break;
    }

    // ---- 3. opsctr and epoch advance --------------------------------------
    if (P.uses_ssmem) {
      const int ctr = opsctr + 1;
      if (ctr >= EPOCH_ADV_OPS) {
        opsctr = 0;
        const int min_e = epoch;
        epoch = min_e + 1;
        if (nlimbo < 0 || nlimbo > A.lcap) FAIL(ERR_LIMBO);
        int freed = 0;
        for (int j = 0; j < nlimbo; ++j) {
          if (limbo_e[j] + 2 > min_e) continue;
          if (j != freed) FAIL(ERR_LIMBO);       // freed set not a prefix
          if (limbo_k[j] == 0) {
            if (nfree < 0 || nfree >= A.fcap) FAIL(ERR_FREE);
            free_p[nfree++] = limbo_a[j];
          } else {
            if (nvfree < 0 || nvfree >= A.vfcap) FAIL(ERR_FREE);
            vfree[nvfree++] = limbo_a[j];
          }
          ++freed;
        }
        if (freed > 0 && freed < nlimbo) {
          rotate_left(limbo_a, nlimbo, freed);
          rotate_left(limbo_e, nlimbo, freed);
          rotate_left(limbo_k, nlimbo, freed);
        }
        nlimbo -= freed;
      } else {
        opsctr = ctr;
      }
    }

    // ---- 4. env binding and allocations -----------------------------------
    int env[N_SYM] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    if (P.code == KIND_ENQ) {
      env[S_TAIL_P] = tail_p;
      env[S_TAIL_V] = tail_v;
    } else {
      if (head < 0) FAIL(ERR_RING);
      const int hpos = head % A.cap;
      env[S_HEAD_P] = dummy_p;
      env[S_HEAD_V] = dummy_v;
      env[S_NEXT_P] = ring_p[hpos];
      env[S_NEXT_V] = ring_v[hpos];
    }
    if (P.prev_slot >= 0) {
      if (P.prev_slot >= A.nslots) FAIL(ERR_SLOT);
      env[S_PREV] = slots[P.prev_slot];
    }
    if (P.allocs_p) {
      if (nfree > 0) {
        if (nfree > A.fcap) FAIL(ERR_FREE);
        env[S_NEW_P] = free_p[--nfree];
      } else {
        env[S_NEW_P] = A.area_base + cursor * LINE_WORDS;
        ++cursor;
      }
    }
    if (P.allocs_v) {
      if (nvfree > 0) {
        if (nvfree > A.vfcap) FAIL(ERR_FREE);
        env[S_NEW_V] = vfree[--nvfree];
      } else {
        env[S_NEW_V] = A.chunk_base + vcursor * A.node_words;
        ++vcursor;
      }
    }

    // ---- 5-7. micro rows, FIFO update, aux rows ---------------------------
    const int* tab = sm + P.table_off;
    for (int r = 0; r <= P.n_rows; ++r) {
      if (r == P.n_micro) {
        if (P.code == KIND_ENQ) {
          const int s = head + length;
          if (s < 0) FAIL(ERR_RING);
          const int pos = s % A.cap;
          ring_p[pos] = P.allocs_p ? env[S_NEW_P] : 0;
          ring_v[pos] = P.allocs_v ? env[S_NEW_V] : 0;
          ++length;
        } else {
          dummy_p = env[S_NEXT_P];
          dummy_v = env[S_NEXT_V];
          head = (head + 1) % A.cap;
          --length;
        }
      }
      if (r == P.n_rows) break;
      const int* row = tab + 5 * r;
      const int kind = row[0], amode = row[1], aval = row[2], off = row[3],
                imm = row[4];
      if (kind == OPC_NOP) continue;
      int a = aval;
      if (amode == 1) {
        if (aval < 0 || aval >= N_SYM) FAIL(ERR_OPCODE);
        a = sym_value(aval, env) + off;
      } else if (amode != 0) {
        FAIL(ERR_OPCODE);
      }
      switch (kind) {
        case OPC_CLASS_V: {
          if (a < 0 || a >= A.nvw) FAIL(ERR_VWORD);
          ++counts[vtouched[a] == 1 ? EV_HIT : EV_DRAM];
          vtouched[a] = 1;
          break;
        }
        case OPC_CLASS_P:
        case OPC_ST_INVAL:
        case OPC_ST_EVERFL:
        case OPC_RECACHE: {
          if (a < 0 || a / LINE_WORDS >= A.nl) FAIL(ERR_LINE);
          const int ln = a / LINE_WORDS;
          if (kind == OPC_CLASS_P) {
            const int ev = cached[ln] == 1   ? EV_HIT
                           : finval[ln] == 1 ? EV_POSTFLUSH
                           : everfl[ln] == 1 ? EV_COLD_NVM
                                             : EV_COLD_DRAM;
            ++counts[ev];
          }
          if (kind == OPC_CLASS_P || kind == OPC_RECACHE) {
            cached[ln] = 1;
            finval[ln] = 0;
          } else if (kind == OPC_ST_INVAL) {
            cached[ln] = 0;
            finval[ln] = 1;
            everfl[ln] = 1;
          } else {
            everfl[ln] = 1;
          }
          break;
        }
        case OPC_LIMBO: {
          if (nlimbo < 0 || nlimbo >= A.lcap) FAIL(ERR_LIMBO);
          limbo_a[nlimbo] = a;
          limbo_e[nlimbo] = epoch;
          limbo_k[nlimbo] = static_cast<uint8_t>(imm);
          ++nlimbo;
          break;
        }
        case OPC_SLOT: {
          if (imm < 0 || imm >= A.nslots) FAIL(ERR_SLOT);
          slots[imm] = a;
          break;
        }
        case OPC_PDISCARD:
        case OPC_PADD: {
          if (a < 0 || a / LINE_WORDS >= A.npers) FAIL(ERR_PERSISTED);
          persisted[a / LINE_WORDS] = kind == OPC_PADD ? 1 : 0;
          break;
        }
        default:
          FAIL(ERR_OPCODE);
      }
    }

    // ---- 8. count commit: the program's static base counts ----------------
    const int* base = sm + P.base_off;
    for (int e = 0; e < N_EV; ++e) counts[e] += base[e];
  }
done:
#undef FAIL
  static_cast<int*>(A.head)[i] = head;
  static_cast<int*>(A.length)[i] = length;
  static_cast<int*>(A.dummy_p)[i] = dummy_p;
  static_cast<int*>(A.dummy_v)[i] = dummy_v;
  static_cast<int*>(A.nfree)[i] = nfree;
  static_cast<int*>(A.cursor)[i] = cursor;
  static_cast<int*>(A.nvfree)[i] = nvfree;
  static_cast<int*>(A.vcursor)[i] = vcursor;
  static_cast<int*>(A.nlimbo)[i] = nlimbo;
  static_cast<int*>(A.epoch)[i] = epoch;
  static_cast<int*>(A.opsctr)[i] = opsctr;
  static_cast<uint8_t*>(A.active)[i] = active ? 1 : 0;
  static_cast<int*>(A.bail_at)[i] = bail_at;
  if (err) atomicOr(static_cast<int*>(A.err), err);
}

extern "C" int fleet_step_launch(const FsArgs* args) {
  if (args->n <= 0 || args->n_ops <= 0) return 0;
  const int blocks = (args->n + BLOCK - 1) / BLOCK;
  const size_t smem = static_cast<size_t>(args->n_consts) * sizeof(int);
  fleet_step_kernel<<<blocks, BLOCK, smem,
                      static_cast<cudaStream_t>(args->stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
