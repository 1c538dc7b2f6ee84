// The two-level V-cycle's Chebyshev smoothing sweeps for Hopper (sm_90a):
// every stage between two coarse corrections in one persistent launch,
// the stages parted by neighbour barriers (each CTA waits for the CTAs
// whose rows it reads or that read its rows), each stage one SELL-C-sigma
// product with D = 1 (the row loop of csrc/sell_row.cuh, which
// csrc/sell_spmv.cu shares, so the product's bits are the SELL kernel's)
// followed by the stage's update at the product's row.
//
// Replaces no Pallas kernel: XLA's fusion of the JAX package's
// `schur.chebyshev` and `make_vcycle_solver` (navierstokes_tpu/solvers/
// schur.py:153-201), matvecs and axpys that eager PyTorch runs as one
// launch per line (about 85 per V-cycle at one cycle and k = 3).  The
// stages, on an assembled P1 operator S (kernels/vcycle.py names them and
// holds their plain versions):
//
//   first:     r0 = r - S x;  d = (sdinv * r0) / theta;  zc = d, where x is
//              the smoothing's z, or z + P y with the coarse correction's
//              prolongation taken in the gather and at the row as
//              z[j] + y[j / agg]; with no z (z = 0) the product is skipped
//              (r - S 0 is r bit for bit: every row sum of zeros is +0) and
//              r0 is r; at k = 1 it writes only out = x + d;
//   step s:    resid = r0 - S zc;  d = c1 d + c2 (sdinv * resid);
//              zc' = zc + d; the last writes only out = x + zc' (0 + zc'
//              with no z);
//   residual:  rc = r - S x.
//
// A sweep is every stage between two coarse corrections (the restriction's
// sum and the coarse GEMV, which stay torch calls):
//
//   pre   the first cycle's pre-smoothing at z = 0 into z0, the residual
//         of z0 into rc;
//   mid   between two cycles: the post-smoothing of z0 + P y into z1, the
//         next pre-smoothing of z1 into z0, the residual of z0 into rc;
//   post  the last post-smoothing of z0 + P y into out.
//
// theta, c1 = rho_new rho and c2 = 2 rho_new / delta are read from the
// coefficient vector the wrapper builds once per operator
// (kernels/vcycle.py `coefficients`, torch's own scalar expressions), so
// no scalar work runs inside a V-cycle.
//
// Rounding: every product, sum, difference and quotient is rounded on its
// own (__fmul_rn, __fadd_rn, __fdiv_rn and the double forms; a - b as
// a + (-b), which IEEE defines as the same), in the operand order of the
// plain version, so no multiply-add is contracted and each sweep writes
// the bits of the torch operations it replaces.
//
// Bound: device-memory traffic, as the product's: a slot's value and
// column (8 bytes in fp32) and a few vectors of n per row against a handful
// of flops.  At the P1 sizes of the step (113,378 rows at the bench point,
// 140,740 in 3D-1Z) the bytes of one stage take about 2-3 us, less than
// the fixed cost of a launch, and a V-cycle reads the operator at every
// stage.  So the design:
//
// * One launch per sweep on a persistent grid: one CTA of 1,024 threads
//   per SM (the occupancy the wrapper reads), each CTA a fixed contiguous
//   range of slices, each warp one, two or four slices of it (R), or any
//   number (R = 0, an operator of more than 4 x 32 slices a CTA; device
//   path), each
//   thread the same rows in every stage.  A V-cycle of n cycles is n + 1
//   sweeps.  The launch is cooperative: the runtime places every CTA at
//   once or refuses it (another context holding SMs, say), so a CTA never
//   waits at a barrier for one that is not placed.
// * The operator on chip: the CTA's slices' values and columns (contiguous
//   in the layout) are copied into its shared memory by two bulk copies
//   (cp.async.bulk onto an mbarrier), issued before griddepcontrol.wait,
//   since the operator is static, so they overlap the grid before.  Every
//   product of the sweep then reads shared memory.  Where a CTA's range
//   does not fit, the same kernel reads device memory through the
//   read-only path, without sell_spmv's evict-first hint, so the operator
//   stays in the L2 for the later stages (the wrapper picks the path from
//   the sizes, or is told).
// * Per-row state in registers: sdinv, r0, d and zc of a thread's rows
//   never leave it; only what neighbours gather goes to device memory (zc,
//   ping-ponged; the smoothing's output; the residual).  At R = 0 a
//   thread's rows come one slice after another, r0 and d in the plan's
//   state vector, zc read back from its own row.  The gathers use
//   ordinary loads (not the read-only path, which is not coherent with the
//   launch's own stores).
// * Neighbour barriers between stages.  A stage of CTA b reads (gathers)
//   only rows of its neighbours N(b), the CTAs that own a column its slots
//   hold, and its rows are read only by CTAs of which it is a neighbour;
//   the wrapper's plan lists N(b) both ways from the operator's columns.
//   So before stage t, b waits until every CTA of N(b) has finished stage
//   t - 1: their stores that t reads have landed (read after write), and
//   their reads of the buffer t overwrites are done (the ping-pong's write
//   after read).  A CTA that is no neighbour neither reads nor writes b's
//   rows, so nothing waits for the whole grid.  Each CTA publishes its
//   progress in a word of its own (the plan's ``flags``; its threads meet,
//   one stores the stage's ticket with release), and one thread per
//   neighbour polls that neighbour's word with acquire before the CTA's
//   threads meet again (the form of CUTLASS's generic barrier).  Tickets
//   count on from the word's value at the launch's start, the same for
//   every CTA since each launch of a plan passes every CTA through the
//   same number of barriers, so the words need no reset and the sweep
//   replays in a CUDA graph and in a while node's body.  No atomics, no
//   sum in any order but the row loop's: repeated runs are bit-identical.
//   A wait that runs 2^24 polls (seconds, where a stage takes
//   microseconds) traps: the launch fails rather than hanging the card.
//   Measured on the H100 (PERF.md section 6): a stage cost 3.71 us with a
//   grid-wide barrier in cooperative groups' form, 3.34 with a grid-wide
//   one of acquire-release fences, 2.75 with this one and 1.35 with none,
//   so the barrier's share is 2.36, 1.99 and 1.40 us.
// * Programmatic dependent launch: the sweep waits for the grid before it
//   (griddepcontrol.wait) after its bulk copies are issued, and lets the
//   next grid be placed (griddepcontrol.launch_dependents) only after its
//   last barrier, when all its CTAs are resident.
//
// Buffers: zc0 and zc1 ping-pong; a last step writes out = x + zc' at its
// own row only; z1 is both the mid sweep's post-smoothing output and its
// pre-smoothing input, z0 its prolongation input and pre-smoothing output
// (a barrier lies between the last read of z0 and the first write).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sell_row.cuh"

namespace {

using sell::kC;
constexpr int kThreads = 1024;               // one CTA per SM
constexpr int kWarps = kThreads / kC;        // slices a CTA takes a round
constexpr uint32_t kPolls = 1u << 24;        // a wait this long is a fault

enum Kind { kPre = 0, kMid = 1, kPost = 2 };

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fadd_rn(a, -b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
};

template <>
struct Rn<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) {
    return __dadd_rn(a, -b);
  }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
};

// the operator's SELL-C-sigma arrays (ops/sell.py)
template <typename T>
struct Sell {
  const T* vals;
  const int* cols;
  const int* slice_ptr;
  const int* rows;
  int n_slices;
};

// the sweep's vectors (kernels/vcycle.py `sweep` names them)
template <typename T>
struct Vecs {
  const T* coef;      // [theta, c1_0, c2_0, c1_1, c2_1, ...]
  const T* sdinv;
  const T* r;
  const T* y;         // the coarse correction (mid, post)
  int agg;            // rows per aggregate
  int k;              // smoothing iterations
  T* zc0;
  T* zc1;
  T* z0;
  T* z1;              // mid
  T* rc;              // pre, mid
  T* out;             // post
  T* state;           // r0 and d of each row, interleaved (R = 0), or null
  unsigned* flags;    // each CTA's progress (the neighbour barriers)
  const int* nb_ptr;  // CTA b's neighbours: nb_idx[nb_ptr[b] .. nb_ptr[b+1])
  const int* nb_idx;
};

// the row loop's gathers: x[c], and (z + P y)[c] = z[c] + y[c / agg]; x and
// z may have been written by this launch, so they take ordinary loads
template <typename T>
struct Gather {
  const T* x;
  __device__ void operator()(int c, T out[1]) const { out[0] = x[c]; }
};

template <typename T>
struct Prolonged {
  const T* z;
  const T* y;
  int agg;
  __device__ void operator()(int c, T out[1]) const {
    out[0] = Rn<T>::add(z[c], __ldg(y + c / agg));
  }
};

// mbarriers and bulk copies (PTX)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t bytes) {
  if (bytes == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                     smem_u32(bar))
                 : "memory");
  else
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == kPolls) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ``bytes`` (a multiple of 16) from global ``src`` to shared ``dst``, both
// 16-byte aligned, completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// this CTA publishes ``ticket`` once its stores before the call are
// visible, then waits until each of its ``nn`` neighbours ``nb`` has
// published ``ticket`` (a later one counts too); the stores those CTAs
// made before they published are visible to every thread after the call.
// The CTA barrier orders its threads' stores before thread 0's release
// (fence.acq_rel, then a relaxed store), and the pollers' acquire loads
// before the CTA's later loads (the form of CUTLASS's generic barrier).
__device__ __forceinline__ void neighbour_barrier(unsigned* flags,
                                                  const int* nb, int nn,
                                                  unsigned ticket) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile(
        "fence.acq_rel.gpu;\n"
        "st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(flags + blockIdx.x),
        "r"(ticket)
        : "memory");
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const unsigned* f = flags + nb[i];
    for (uint32_t polls = 0;
         static_cast<int>(ld_acquire(f) - ticket) < 0; ++polls)
      if (polls == kPolls) __trap();
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned v;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(v));
  return v;
}

// no product: the first stage of a smoothing at z = 0
struct NoProduct {};

// A CTA's view of the sweep: its operator (shared or device memory) and
// its rows, one of each slice a thread.  R > 0: R slices a warp, the rows'
// slots and state (sdinv, r0, d, zc) in registers.  R = 0: any number of
// slices a warp, one after another, r0 and d in the plan's state vector
// (state[2 i], state[2 i + 1]), zc read back from its ping-pong buffer at
// the thread's own row, sdinv from its vector (the operators whose CTAs
// hold more slices than the register arrays).
template <typename T, int R, bool Shared>
struct Sweep {
  using L = typename std::conditional<Shared, sell::Plain, sell::Keep>::type;
  using Rt = Rn<T>;
  static constexpr bool kRegs = R > 0;
  static constexpr int kR = kRegs ? R : 1;
  Sell<T> mat;         // the operator's arrays in device memory
  int s0, s1, base;    // the CTA's slices [s0, s1), its first slot
  const T* vals;       // the operator's values and columns, indexed from
  const int* cols;     // the CTA's first slot (shared) or from 0 (device)
  uint64_t* full;      // the bulk copies' mbarrier (shared)
  bool ready;
  int lane, warp;
  int barriers_left;   // the launch lets the next grid in after the last
  unsigned ticket;     // the last barrier's ticket
  const int* nb;       // the CTA's neighbours
  int nn;
  Vecs<T> v;
  int row[kR], beg[kR], width[kR];
  T sdinv[kR], r0[kR], d[kR], zc[kR];

  __device__ void barrier() {
    neighbour_barrier(v.flags, nb, nn, ++ticket);
    if (--barriers_left == 0)
      asm volatile("griddepcontrol.launch_dependents;" :::);
  }

  __device__ T sum(const NoProduct&, int, int) const { return T(0); }

  template <typename X>
  __device__ T sum(const X& x, int b, int w) const {
    T a[1] = {T(0)};
    sell::row_sum<T, 1, X, L>(vals, cols, b, w, lane, x, a);
    return a[0];
  }

  // a row's state: register j (R > 0) or the state vector at row i
  __device__ T& r0_at(int j, int i) {
    if constexpr (kRegs) return r0[j];
    else return v.state[2 * i];
  }
  __device__ T& d_at(int j, int i) {
    if constexpr (kRegs) return d[j];
    else return v.state[2 * i + 1];
  }
  __device__ T sdinv_at(int j, int i) const {
    if constexpr (kRegs) return sdinv[j];
    else return __ldg(v.sdinv + i);
  }

  // one stage: for each of the thread's rows i, acc = (S x)[i] (0 with no
  // product), then update(j, i, acc); with the state in registers every
  // product of the thread is taken before the first update
  template <typename X, typename U>
  __device__ void stage(const X& x, U update) {
    constexpr bool kProduct = !std::is_same<X, NoProduct>::value;
    if (kProduct && Shared && !ready) {
      mbar_wait(full, 0);
      ready = true;
    }
    if constexpr (kRegs) {
      T acc[R];
#pragma unroll
      for (int j = 0; j < R; ++j)
        acc[j] = row[j] >= 0 ? sum(x, beg[j], width[j]) : T(0);
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (row[j] >= 0) update(j, row[j], acc[j]);
    } else {
      for (int slice = s0 + warp; slice < s1; slice += kWarps) {
        const int i = mat.rows[slice * kC + lane];
        if (i < 0) continue;
        const int p = mat.slice_ptr[slice];
        update(0, i, sum(x, p - base, (mat.slice_ptr[slice + 1] - p) / kC));
      }
    }
  }

  // x at row i: z[i] (HasZ), z[i] + y[i / agg] (Prolong) or 0
  template <bool HasZ, bool Prolong>
  __device__ T x_at(const T* z, int i) const {
    if constexpr (Prolong) return Rt::add(z[i], __ldg(v.y + i / v.agg));
    if constexpr (HasZ) return z[i];
    return T(0);
  }

  // a smoothing's first stage: its product on z + P y (Prolong), z (HasZ)
  // or none
  template <bool HasZ, bool Prolong, typename U>
  __device__ void first_stage(const T* z, U update) {
    if constexpr (Prolong)
      stage(Prolonged<T>{z, v.y, v.agg}, update);
    else if constexpr (HasZ)
      stage(Gather<T>{z}, update);
    else
      stage(NoProduct{}, update);
  }

  // one smoothing: out = x + chebyshev(r - S x) for x = z (HasZ), z + P y
  // (Prolong) or 0, k stages parted by k - 1 barriers
  template <bool HasZ, bool Prolong>
  __device__ void smooth(const T* z, T* out) {
    const int k = v.k;
    const T theta = v.coef[0];
    first_stage<HasZ, Prolong>(z, [&](int j, int i, T acc) {
      const T r0v = HasZ ? Rt::sub(v.r[i], acc) : v.r[i];
      const T dv = Rt::div(Rt::mul(sdinv_at(j, i), r0v), theta);
      if (k == 1) {
        out[i] = Rt::add(x_at<HasZ, Prolong>(z, i), dv);
        return;
      }
      v.zc0[i] = dv;
      r0_at(j, i) = r0v;
      d_at(j, i) = dv;
      if constexpr (kRegs) zc[j] = dv;
    });
    for (int s = 0; s < k - 1; ++s) {
      barrier();
      const T* x = s % 2 ? v.zc1 : v.zc0;
      T* next = s % 2 ? v.zc0 : v.zc1;
      const T c1 = v.coef[1 + 2 * s];
      const T c2 = v.coef[2 + 2 * s];
      const bool last = s == k - 2;
      stage(Gather<T>{x}, [&](int j, int i, T acc) {
        const T resid = Rt::sub(r0_at(j, i), acc);
        const T dv = Rt::add(Rt::mul(c1, d_at(j, i)),
                             Rt::mul(c2, Rt::mul(sdinv_at(j, i), resid)));
        T zv;
        if constexpr (kRegs)
          zv = Rt::add(zc[j], dv);
        else
          zv = Rt::add(x[i], dv);     // this thread's own store
        if (last) {
          out[i] = Rt::add(x_at<HasZ, Prolong>(z, i), zv);
          return;
        }
        next[i] = zv;
        d_at(j, i) = dv;
        if constexpr (kRegs) zc[j] = zv;
      });
    }
  }

  // rc = r - S x
  __device__ void residual(const T* x) {
    stage(Gather<T>{x},
          [&](int, int i, T acc) { v.rc[i] = Rt::sub(v.r[i], acc); });
  }
};

template <typename T, int Kind, int R, bool Shared>
__global__ void __launch_bounds__(kThreads, 1)
    vcycle_sweep(Sell<T> s, Vecs<T> v) {
  using W = Sweep<T, R, Shared>;
  extern __shared__ __align__(16) unsigned char smem[];
  W w;
  w.mat = s;
  w.s0 = static_cast<int>(static_cast<long long>(blockIdx.x) * s.n_slices /
                          gridDim.x);
  w.s1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                          s.n_slices / gridDim.x);
  // the wrapper's plan: R rounds cover the range, or (R = 0) the state
  if (R > 0 ? w.s1 - w.s0 > kWarps * R : v.state == nullptr) __trap();
  w.v = v;
  w.lane = threadIdx.x % kC;
  w.warp = threadIdx.x / kC;
  w.ready = !Shared;
  w.barriers_left = Kind == kPre ? v.k : Kind == kMid ? 2 * v.k : v.k - 1;
  // before the wait: only the operator, which is static
  w.base = 0;
  if (Shared) {
    w.base = s.slice_ptr[w.s0];
    const int slots = s.slice_ptr[w.s1] - w.base;
    const uint32_t vbytes = slots * sizeof(T);
    w.full = reinterpret_cast<uint64_t*>(smem);
    T* sv = reinterpret_cast<T*>(smem + 16);
    int* sc = reinterpret_cast<int*>(smem + 16 + vbytes);
    if (16 + vbytes + 4u * slots > dynamic_smem_bytes()) __trap();
    if (threadIdx.x == 0) mbar_init(w.full);
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_arrive(w.full, vbytes + 4u * slots);
      if (slots > 0) {
        bulk_copy(sv, s.vals + w.base, vbytes, w.full);
        bulk_copy(sc, s.cols + w.base, 4u * slots, w.full);
      }
    }
    w.vals = sv;
    w.cols = sc;
  } else {
    w.vals = s.vals;
    w.cols = s.cols;
  }
  w.nb = v.nb_idx + v.nb_ptr[blockIdx.x];
  w.nn = v.nb_ptr[blockIdx.x + 1] - v.nb_ptr[blockIdx.x];
#pragma unroll
  for (int j = 0; j < W::kR; ++j) {
    const int slice = w.s0 + w.warp + j * kWarps;
    w.row[j] = -1;
    w.beg[j] = w.width[j] = 0;
    if (R > 0 && slice < w.s1) {
      const int p = s.slice_ptr[slice];
      w.beg[j] = p - w.base;
      w.width[j] = (s.slice_ptr[slice + 1] - p) / kC;
      w.row[j] = s.rows[slice * kC + w.lane];
    }
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // the grid before has finished: this CTA's word holds the ticket every
  // CTA of the plan reached in its last launch
  w.ticket = *static_cast<volatile unsigned*>(v.flags + blockIdx.x);
  if (w.barriers_left == 0)
    asm volatile("griddepcontrol.launch_dependents;" :::);
#pragma unroll
  for (int j = 0; j < W::kR; ++j)
    w.sdinv[j] = w.row[j] >= 0 ? v.sdinv[w.row[j]] : T(0);
  if (Kind == kPre) {
    w.template smooth<false, false>(nullptr, v.z0);
    w.barrier();
    w.residual(v.z0);
  } else if (Kind == kMid) {
    w.template smooth<true, true>(v.z0, v.z1);
    w.barrier();
    w.template smooth<true, false>(v.z1, v.z0);
    w.barrier();
    w.residual(v.z0);
  } else {
    w.template smooth<true, true>(v.z0, v.out);
  }
}

template <typename T>
using SweepKernel = void (*)(Sell<T>, Vecs<T>);

// the kernel of (kind, slices a warp in registers or 0, path); null for an
// R it lacks.  R = 0 runs on the device path only: a CTA of more than
// 4 x 32 slices holds more slots than shared memory at the P1 operators'
// widths
template <typename T>
SweepKernel<T> pick(int kind, int rounds, int shared) {
#define NST_PICK(K, R)                                                 \
  if (kind == K && rounds == R)                                        \
    return shared ? vcycle_sweep<T, K, R, true> : vcycle_sweep<T, K, R, false>;
  NST_PICK(kPre, 1) NST_PICK(kPre, 2) NST_PICK(kPre, 4)
  NST_PICK(kMid, 1) NST_PICK(kMid, 2) NST_PICK(kMid, 4)
  NST_PICK(kPost, 1) NST_PICK(kPost, 2) NST_PICK(kPost, 4)
#undef NST_PICK
  if (rounds == 0 && !shared)
    return kind == kPre ? vcycle_sweep<T, kPre, 0, false>
           : kind == kMid ? vcycle_sweep<T, kMid, 0, false>
           : kind == kPost ? vcycle_sweep<T, kPost, 0, false>
                           : nullptr;
  return nullptr;
}

// For the wrapper's plan: raises the kernels' shared-memory limit to the
// card's opt-in limit (shared path; a limit, not a reservation, so every
// plan on the card launches under it) and writes info = [CTAs an SM holds
// at ``smem`` bytes (the least over the three kinds), SMs, the opt-in
// limit, threads a CTA, registers a thread (the most over the kinds),
// local-memory bytes a thread (the most)].
template <typename T>
int setup(int rounds, int shared, int smem, int* info) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 1 << 30, regs = 0, local = 0;
  for (int kind = kPre; kind <= kPost; ++kind) {
    const auto K = pick<T>(kind, rounds, shared);
    if (K == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (shared) {
      e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, K, kThreads,
                                                      shared ? smem : 0);
    cudaFuncAttributes a;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, K);
    if (e != cudaSuccess) return static_cast<int>(e);
    per_sm = n < per_sm ? n : per_sm;
    regs = a.numRegs > regs ? a.numRegs : regs;
    local = static_cast<int>(a.localSizeBytes) > local
                ? static_cast<int>(a.localSizeBytes)
                : local;
  }
  info[0] = per_sm;
  info[1] = sms;
  info[2] = optin;
  info[3] = kThreads;
  info[4] = regs;
  info[5] = local;
  return 0;
}

// Launches the sweep ``kind`` on ``grid`` CTAs as a cooperative launch
// (the runtime places every CTA at once or refuses the launch, so no CTA
// waits at a barrier for one that never runs) with programmatic stream
// serialization; returns cudaGetLastError() after the launch.  Does not
// synchronise.
template <typename T>
int sweep(int kind, const Sell<T>& s, const Vecs<T>& v, int grid, int rounds,
          int shared, int smem, void* stream) {
  if (s.n_slices <= 0) return 0;
  const auto K = pick<T>(kind, rounds, shared);
  if (K == nullptr || grid < 1 || v.k < 1 ||
      (rounds == 0) != (v.state != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shared ? smem : 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, K, s, v);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry per sweep and dtype (kernels/vcycle.py passes exactly these
// arguments): the launch's plan (CTAs, slices a warp in registers or 0,
// shared path, dynamic shared-memory bytes), the operator's SELL arrays
// and slice count, then the sweep's vectors and the plan's state vector
// (2 n, rounds 0; else null), barrier words and neighbour lists; each
// returns 0 or the CUDA error of the launch.  ``nst_vcycle_setup_*``
// serves the plan.
#define NST_PLAN int grid, int rounds, int shared, int smem
#define NST_SELL(T)                                                      \
  const T *vals, const int *cols, const int *slice_ptr, const int *rows, \
      int n_slices
#define NST_SYNC(T) \
  T *state, unsigned *flags, const int *nb_ptr, const int *nb_idx
#define NST_S {vals, cols, slice_ptr, rows, n_slices}
#define NST_VCYCLE_ENTRIES(T, SUFFIX)                                        \
  int nst_vcycle_setup_##SUFFIX(int rounds, int shared, int smem,           \
                                int* info) {                                \
    return setup<T>(rounds, shared, smem, info);                            \
  }                                                                         \
  int nst_vcycle_pre_##SUFFIX(NST_PLAN, NST_SELL(T), const T* coef,         \
                              const T* sdinv, const T* r, int k, T* zc0,    \
                              T* zc1, T* z0, T* rc, NST_SYNC(T),            \
                              void* stream) {                               \
    const Vecs<T> v = {coef,  sdinv, r,      nullptr, 0,      k,            \
                       zc0,   zc1,   z0,     nullptr, rc,     nullptr,      \
                       state, flags, nb_ptr, nb_idx};                       \
    return sweep<T>(kPre, NST_S, v, grid, rounds, shared, smem, stream);    \
  }                                                                         \
  int nst_vcycle_mid_##SUFFIX(NST_PLAN, NST_SELL(T), const T* coef,         \
                              const T* sdinv, const T* r, const T* y,       \
                              int agg, int k, T* zc0, T* zc1, T* z0, T* z1, \
                              T* rc, NST_SYNC(T), void* stream) {           \
    const Vecs<T> v = {coef,  sdinv, r,      y,       agg,    k,            \
                       zc0,   zc1,   z0,     z1,      rc,     nullptr,      \
                       state, flags, nb_ptr, nb_idx};                       \
    return sweep<T>(kMid, NST_S, v, grid, rounds, shared, smem, stream);    \
  }                                                                         \
  int nst_vcycle_post_##SUFFIX(NST_PLAN, NST_SELL(T), const T* coef,        \
                               const T* sdinv, const T* r, const T* y,      \
                               int agg, int k, T* zc0, T* zc1, T* z0,       \
                               T* out, NST_SYNC(T), void* stream) {         \
    const Vecs<T> v = {coef,  sdinv, r,      y,       agg,    k,            \
                       zc0,   zc1,   z0,     nullptr, nullptr, out,         \
                       state, flags, nb_ptr, nb_idx};                       \
    return sweep<T>(kPost, NST_S, v, grid, rounds, shared, smem, stream);   \
  }

extern "C" {
NST_VCYCLE_ENTRIES(float, f32)
NST_VCYCLE_ENTRIES(double, f64)
}  // extern "C"
