// The vector updates of BiCGStab's and CG's iterations on the card
// (sm_90a), one fused kernel per update stage.
//
// Replaces no Pallas kernel: the JAX package runs each loop body inside one
// `lax.while_loop`, and XLA fuses its scalar algebra and vector updates
// (navierstokes_tpu/solvers/krylov.py:204-224 BiCGStab, :258-268 CG).  The
// port's plain body (kernels/krylov_update.py) runs them as torch
// operations, about 50 launches per BiCGStab and 19 per CG iteration
// besides the products and the dots.  Here each stage between two
// products is one launch that reads the 0-d device scalars itself:
//
//   bicgstab_p   beta from rho_new, rho, alpha, omega (the eps guards),
//                p = r + beta (p - omega v)
//   bicgstab_s   alpha = rho_new / guard(r0.v), s = r - alpha v, and the
//                new v (the product's output) into the loop's v
//   bicgstab_xr  alpha again, omega = (t.s) / guard(t.t),
//                x = (x + alpha phat) + omega shat, r = s - omega t, and
//                the committed rho, alpha, omega, the breakdown flag, k
//   cg_xr        pap = p.Ap, alpha = rz / clamp(pap), x += alpha p,
//                r -= alpha Ap, and rnorm = ||r|| of the new r
//   cg_p         rz_new = r.z, beta = rz_new / clamp(rz), p = z + beta p,
//                rz = rz_new, k
//
// Every state buffer (x, r, p, v, rho, alpha, omega, stag, rz, pap, rnorm,
// k) is written only while the loop's flag `active` is up, so an
// iteration run after the stop (krylov MASKED blocks) leaves the state
// bit-identical, as the plain body's `torch.where(active, new, old)`
// does.  Intermediates go to scratch (s).  No kernel reads a scalar that
// the same launch writes before every CTA has read it: a 0-d commit is
// one thread's store, and cg_p's store of rz comes after the cluster
// barrier that every CTA reaches after its read of rz.
//
// Same bits as the plain body, in float and double: each product, sum,
// difference and quotient is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn and the __d*_rn forms), in torch's order, so nvcc
// contracts nothing into a fused multiply-add (the build leaves -fmad=true).
// torch's `a + b` and `a - b` on the card are `a + alpha * b` with
// alpha = +-1, exact before the one rounding, so they round as one add.
//
// BiCGStab.  Bound: bytes.  Each element is read and written once per
// stage (p: 3 reads, 1 write; s: 2 and 2; x and r: 5 and 2), a few flops
// each.  One element loop serves every stage, on one of three paths that
// the wrapper picks from the vectors' addresses (a pure function of their
// alignment, kernels/krylov_update.path):
//
//   vector   every vector starts on a 16-byte boundary: 16-byte loads and
//            stores (float4, double2), kUnroll of them per thread per
//            trip, all loads of a trip issued before its first store;
//   peeled   every vector sits the same number of bytes off a boundary
//            (views into one flat (u, p) vector): a scalar head of
//            `head` elements up to the boundary, then the vector loop;
//   scalar   the vectors disagree: 4-byte (8-byte) loads, kUnroll times
//            the vector width of them per thread per trip, loaded first.
//
// The tail of n past the last whole vector is scalar, in the same launch.
// Thread 0 of each CTA reads the 0-d scalars once and derives beta, alpha
// or omega into shared memory while the CTA's first loads are in flight.
// The grid: one trip's CTAs, rounded up to whole waves of the SMs, at
// most what the card holds at once (the occupancy).  Every element takes
// the same rounded operations in the same order on every path.  Measured
// (PERF.md section 6): about 3 us fixed per launch plus the bytes at
// about 3 TB/s, so at the bench point's 901,036 entries the fixed cost
// keeps the fp32 stages at 52-63% of their bound.
//
// CG.  Each stage takes its own dot: cg_xr p.Ap and ||r_new||^2, cg_p
// r.z, so an iteration launches the product, cg_xr, the preconditioner,
// cg_p and the predicate, and no dot or norm of its own.  A stage cannot
// update an element before its dot is complete, and at the P1 sizes of
// the projection step (113,378 at the bench point, about 141k in 3D-1Z)
// the fixed cost of a launch, not the 1-3 MB it moves, is the time.  So
// each stage is one launch of one thread-block cluster of kCluster CTAs
// (cudaLaunchKernelEx with a cluster dimension; 16 is above the portable
// 8 and needs cudaFuncAttributeNonPortableClusterSizeAllowed):
//
//   * each thread loads its elements of the dot's inputs (and of what it
//     updates) into registers, kCgHold loads of the path's unit per input,
//     all issued before the first sum, and keeps them across the barrier,
//     so a vector that fits one pass (kCgThreads x kCluster x kCgHold
//     units: 131,072 fp32 elements on the vector path) is read once; past
//     that, further passes of the same size read their part again (from
//     the L2) after the barrier;
//   * the three paths of the BiCGStab loop (vector, peeled, scalar), the
//     unit being a 16-byte vector or one element;
//   * each product in float64 (exact for float data) and summed in float64
//     in a fixed order: each thread over its elements, a butterfly of
//     shuffles in each warp, the warps' sums through shared memory, then
//     every CTA stores its sum into a slot of every CTA's shared memory
//     (distributed shared memory, one store per CTA pair), and after the
//     cluster barrier each CTA adds the slots in rank order: every CTA
//     gets the same value, rounded once to T.  No atomics, no counter, no
//     last-CTA step: a rerun gives the same bits;
//   * cg_xr's ||r_new||^2 goes the same way into rank 0's slots only;
//     rank 0 writes sqrt of it (rounded once) as rnorm, and the committed
//     pap, after a second barrier;
//   * the launch allows programmatic dependent launch: the stage's CTAs
//     are placed while the kernel before it drains and wait for it
//     (griddepcontrol.wait) before their first read.
//
// Measured (PERF.md section 6): one cluster of 16 CTAs beats 8, 512
// threads a CTA beat 1024, and the programmatic launch saves about 0.5 us
// per CG iteration under a while node; a stage takes 6-9 us at the bench
// point, where the launches it replaces (the dot, the stage, the norm)
// took 12-26 us.
//
// The plain versions round the same float64 sums once (in torch's order of
// summation), so in fp32 the dots and the norm are equal or one ulp apart
// and, where equal, every vector equals the plain one bit for bit.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                // 16-byte vectors per thread per trip

enum Path { kScalar = 0, kVector = 1, kPeeled = 2 };

template <typename T> struct Rn;

template <> struct Rn<float> {
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ float div(float a, float b) { return __fdiv_rn(a, b); }
};

template <> struct Rn<double> {
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int kWidth = 4;
  static __device__ float get(const float4& v, int c) {
    return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
  }
  static __device__ void set(float4& v, int c, float a) {
    if (c == 0) v.x = a;
    else if (c == 1) v.y = a;
    else if (c == 2) v.z = a;
    else v.w = a;
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int kWidth = 2;
  static __device__ double get(const double2& v, int c) {
    return c == 0 ? v.x : v.y;
  }
  static __device__ void set(double2& v, int c, double a) {
    if (c == 0) v.x = a;
    else v.y = a;
  }
};

// torch.where(a.abs() > eps, a, eps)
template <typename T> __device__ T guard(T a, T eps) {
  return fabs(a) > eps ? a : eps;
}

// torch.clamp(a, min=1e-30): NaN passes through
template <typename T> __device__ T clamp_tiny(T a) {
  const T lo = T(1e-30);
  return isnan(a) ? a : (a < lo ? lo : a);
}

__device__ bool first_thread() {
  return blockIdx.x == 0 && threadIdx.x == 0;
}

// y = f(x) for the n elements of the K vectors `in`, into the L vectors
// `out` (an output may be an input: each element is read, then written,
// by one thread).  `ready()` runs once all threads have issued their first
// loads; it returns -1 to stop (the flag down), else the mask of the
// outputs to write.
template <int PATH, typename T, int K, int L, typename Ready, typename F>
__device__ __forceinline__ void for_each(long long n, const T* const (&in)[K],
                                         T* const (&out)[L], Ready ready,
                                         F f) {
  using V = Vec<T>;
  using VT = typename V::type;
  constexpr int W = V::kWidth;
  const long long tid = blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x;
  const long long nth = static_cast<long long>(gridDim.x) * kThreads;
  // peeled: every vector sits as far off a 16-byte boundary as the first
  const long long off = reinterpret_cast<unsigned long long>(in[0]) & 15;
  const long long head = off ? (16 - off) / static_cast<long long>(sizeof(T))
                             : 0;
  const long long h = PATH == kPeeled ? (head < n ? head : n) : 0;
  const long long nv = PATH == kScalar ? 0 : (n - h) / W;
  VT x[kUnroll][K];
  auto load = [&](long long b) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long idx = b + u * nth;
      if (idx < nv) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          x[u][k] = reinterpret_cast<const VT*>(in[k] + h)[idx];
      }
    }
  };
  load(tid);
  const int mask = ready();
  if (mask < 0) return;
  auto scalar = [&](long long i) {
    T xs[K], ys[L];
#pragma unroll
    for (int k = 0; k < K; ++k) xs[k] = in[k][i];
    f(xs, ys);
#pragma unroll
    for (int l = 0; l < L; ++l)
      if (mask >> l & 1) out[l][i] = ys[l];
  };
  if (PATH == kScalar) {
    // kUnroll * W elements per thread per trip, all loaded first
    for (long long b = tid; b < n; b += nth * kUnroll * W) {
      T xs[kUnroll * W][K];
#pragma unroll
      for (int u = 0; u < kUnroll * W; ++u) {
        const long long i = b + u * nth;
        if (i < n) {
#pragma unroll
          for (int k = 0; k < K; ++k) xs[u][k] = in[k][i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll * W; ++u) {
        const long long i = b + u * nth;
        if (i < n) {
          T ys[L];
          f(xs[u], ys);
#pragma unroll
          for (int l = 0; l < L; ++l)
            if (mask >> l & 1) out[l][i] = ys[l];
        }
      }
    }
    return;
  }
  for (long long i = tid; i < h; i += nth) scalar(i);
  for (long long b = tid; b < nv; b += nth * kUnroll) {
    if (b != tid) load(b);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long idx = b + u * nth;
      if (idx < nv) {
        VT y[L];
#pragma unroll
        for (int c = 0; c < W; ++c) {
          T xs[K], ys[L];
#pragma unroll
          for (int k = 0; k < K; ++k) xs[k] = V::get(x[u][k], c);
          f(xs, ys);
#pragma unroll
          for (int l = 0; l < L; ++l) V::set(y[l], c, ys[l]);
        }
#pragma unroll
        for (int l = 0; l < L; ++l)
          if (mask >> l & 1) reinterpret_cast<VT*>(out[l] + h)[idx] = y[l];
      }
    }
  }
  for (long long i = h + nv * W + tid; i < n; i += nth) scalar(i);
}

template <typename T, int PATH>
__global__ void __launch_bounds__(kThreads)
bicgstab_p(long long n, T* p, const T* r, const T* v,
           const T* __restrict__ rho_new, const T* __restrict__ rho,
           const T* __restrict__ alpha, const T* __restrict__ omega,
           const T* __restrict__ eps, const bool* __restrict__ active) {
  using R = Rn<T>;
  __shared__ T sc[2];
  __shared__ bool up;
  T beta, om;
  const T* in[3] = {p, r, v};
  T* const out[1] = {p};
  auto ready = [&]() -> int {
    if (threadIdx.x == 0) {
      up = *active;
      const T e = *eps, o = *omega;
      sc[0] = R::mul(R::div(*rho_new, guard(*rho, e)),
                     R::div(*alpha, guard(o, e)));
      sc[1] = o;
    }
    __syncthreads();
    beta = sc[0];
    om = sc[1];
    return up ? 1 : -1;
  };
  for_each<PATH, T, 3, 1>(n, in, out, ready,
                    [&](const T* x, T* y) {
                      y[0] = R::add(x[1],
                                    R::mul(beta, R::sub(x[0],
                                                        R::mul(om, x[2]))));
                    });
}

template <typename T, int PATH>
__global__ void __launch_bounds__(kThreads)
bicgstab_s(long long n, T* s, T* v_state, const T* r,
           const T* v, const T* __restrict__ rho_new,
           const T* __restrict__ denom, const T* __restrict__ eps,
           const bool* __restrict__ active) {
  using R = Rn<T>;
  __shared__ T sc;
  __shared__ bool up;
  T alpha;
  const T* in[2] = {r, v};
  T* const out[2] = {s, v_state};
  auto ready = [&]() -> int {
    if (threadIdx.x == 0) {
      up = *active;
      sc = R::div(*rho_new, guard(*denom, *eps));
    }
    __syncthreads();
    alpha = sc;
    return up ? 3 : 1;          // s always, the loop's v under the flag
  };
  for_each<PATH, T, 2, 2>(n, in, out, ready, [&](const T* x, T* y) {
    y[0] = R::sub(x[0], R::mul(alpha, x[1]));
    y[1] = x[1];
  });
}

template <typename T, int PATH>
__global__ void __launch_bounds__(kThreads)
bicgstab_xr(long long n, T* x, T* r, const T* phat,
            const T* shat, const T* s, const T* t,
            const T* __restrict__ rho_new, const T* __restrict__ denom,
            const T* __restrict__ ts, const T* __restrict__ tt,
            const T* __restrict__ eps, T* __restrict__ rho,
            T* __restrict__ alpha_state, T* __restrict__ omega_state,
            bool* __restrict__ stag, long long* __restrict__ k,
            const bool* __restrict__ active) {
  using R = Rn<T>;
  __shared__ T sc[2];
  __shared__ bool up;
  T alpha, omega;
  const T* in[5] = {x, phat, shat, s, t};
  T* const out[2] = {x, r};
  auto ready = [&]() -> int {
    if (threadIdx.x == 0) {
      up = *active;
      const T e = *eps, rn = *rho_new, dn = *denom, t2 = *tt;
      sc[0] = R::div(rn, guard(dn, e));
      sc[1] = R::div(*ts, t2 > e ? t2 : e);
      if (up && blockIdx.x == 0) {
        *rho = rn;
        *alpha_state = sc[0];
        *omega_state = sc[1];
        *stag = fabs(rn) <= e || fabs(dn) <= e;
        *k += 1;
      }
    }
    __syncthreads();
    alpha = sc[0];
    omega = sc[1];
    return up ? 3 : -1;
  };
  for_each<PATH, T, 5, 2>(n, in, out, ready, [&](const T* a, T* y) {
    y[0] = R::add(R::add(a[0], R::mul(alpha, a[1])), R::mul(omega, a[2]));
    y[1] = R::sub(a[3], R::mul(omega, a[4]));
  });
}

// ---- CG: one thread-block cluster per stage ----------------------------

constexpr int kCluster = 16;     // CTAs of the stage's one cluster
constexpr int kCgThreads = 512;  // threads of each CTA
constexpr int kCgWarps = kCgThreads / 32;
constexpr int kCgHold = 4;       // units per input a thread holds
static_assert(kCluster >= 1 && kCluster <= 16, "a cluster holds 1-16 CTAs");
static_assert(kCgThreads % 32 == 0 && kCgWarps <= 32,
              "cta_sum adds at most one warp's sums per lane");

// The load unit of a path: a 16-byte vector on the vector and peeled
// paths, one element on the scalar path.
template <typename T, int PATH> struct Unit {
  using type = typename Vec<T>::type;
  static constexpr int kWidth = Vec<T>::kWidth;
  static constexpr int kHold = kCgHold;
  static __device__ T get(const type& v, int c) { return Vec<T>::get(v, c); }
  static __device__ void set(type& v, int c, T a) { Vec<T>::set(v, c, a); }
};
template <typename T> struct Unit<T, kScalar> {
  using type = T;
  static constexpr int kWidth = 1;
  static constexpr int kHold = kCgHold * Vec<T>::kWidth;
  static __device__ T get(const T& v, int) { return v; }
  static __device__ void set(T& v, int, T a) { v = a; }
};

// The cluster's elements on a path: a scalar head of h elements (peeled),
// nv units, then the scalar tail from t0 to n.  Thread `tid` of the
// cluster's nth takes units tid + u nth + c cap of pass c (u < kHold),
// head element tid and tail element t0 + tid.
template <typename T, int PATH> struct Span {
  long long h, nv, t0, tid, nth, cap;
  __device__ Span(long long n, const void* first, unsigned rank) {
    using Un = Unit<T, PATH>;
    const long long off = reinterpret_cast<unsigned long long>(first) & 15;
    const long long head =
        off ? (16 - off) / static_cast<long long>(sizeof(T)) : 0;
    h = PATH == kPeeled ? (head < n ? head : n) : 0;
    nv = (n - h) / Un::kWidth;
    t0 = h + nv * Un::kWidth;
    tid = static_cast<long long>(rank) * kCgThreads + threadIdx.x;
    nth = static_cast<long long>(kCluster) * kCgThreads;
    cap = nth * Un::kHold;
  }
};

template <typename U, typename T>
__device__ __forceinline__ U load_unit(const T* base, long long i) {
  return reinterpret_cast<const U*>(base)[i];
}
template <typename U, typename T>
__device__ __forceinline__ void store_unit(T* base, long long i, U v) {
  reinterpret_cast<U*>(base)[i] = v;
}

// a b in float64 (exact for float a and b), as the plain version takes it
template <typename T> __device__ __forceinline__ double prod64(T a, T b) {
  return __dmul_rn(static_cast<double>(a), static_cast<double>(b));
}

template <typename T> __device__ __forceinline__ T round_to(double a);
template <> __device__ __forceinline__ float round_to<float>(double a) {
  return __double2float_rn(a);
}
template <> __device__ __forceinline__ double round_to<double>(double a) {
  return a;
}

// the start of a CG stage: wait for the grid before it (the stage is
// launched with programmatic stream serialization, so its CTAs may be
// placed while that grid drains), then the opening arrive of the cluster
// barrier
__device__ __forceinline__ void cg_start() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// the barrier's arrive with release (this thread's stores, remote ones
// included, are visible to whoever waits with acquire); cg_start's
// relaxed arrive only says that the CTA runs
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
// slot (an address in this CTA's shared memory) in CTA `rank`'s <- v
__device__ __forceinline__ void store_remote(double* slot, unsigned rank,
                                             double v) {
  const unsigned local =
      static_cast<unsigned>(__cvta_generic_to_shared(slot));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f64 [%0], %1;"
               :: "r"(remote), "d"(v) : "memory");
}
__device__ __forceinline__ double load_slot(const double* slot) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(slot)))
               : "memory");
  return v;
}

// The CTA's sum of v, in one order: a butterfly in each warp (a + b and
// b + a round alike, so every lane ends with the same bits), then each
// warp adds the warps' sums the same way.  Every thread returns it.
__device__ __forceinline__ double cta_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = lane < kCgWarps ? red[lane] : 0.0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// The cluster's sum of v into every CTA: each CTA's sum into slot[rank] of
// every CTA, the barrier, then the slots in rank order.  The first wait
// closes the kernel's opening arrive (every CTA runs before any store
// lands in its shared memory).
__device__ __forceinline__ double cluster_sum_all(double v, double* red,
                                                  double* slot,
                                                  unsigned rank) {
  const double s = cta_sum(v, red);
  cluster_wait();
  if (threadIdx.x < kCluster) store_remote(slot + rank, threadIdx.x, s);
  cluster_arrive();
  cluster_wait();
  double t = 0.0;
#pragma unroll
  for (int q = 0; q < kCluster; ++q) t = __dadd_rn(t, load_slot(slot + q));
  return t;
}

// The cluster's sum of v, in rank 0 only (the others return 0).
__device__ __forceinline__ double cluster_sum_rank0(double v, double* red,
                                                    double* slot,
                                                    unsigned rank) {
  const double s = cta_sum(v, red);
  if (threadIdx.x == 0) store_remote(slot + rank, 0, s);
  cluster_arrive();
  cluster_wait();
  double t = 0.0;
  if (rank == 0) {
#pragma unroll
    for (int q = 0; q < kCluster; ++q) t = __dadd_rn(t, load_slot(slot + q));
  }
  return t;
}

// pap = p.Ap, alpha = rz / clamp(pap), x += alpha p, r -= alpha Ap,
// rnorm = ||r||: one cluster (see the top of the file).
template <typename T, int PATH>
__global__ void __launch_bounds__(kCgThreads, 1)
cg_xr(long long n, T* x, T* r, const T* p, const T* ap,
      const T* __restrict__ rz, T* __restrict__ pap, T* __restrict__ rnorm,
      const bool* __restrict__ active) {
  using R = Rn<T>;
  using Un = Unit<T, PATH>;
  using U = typename Un::type;
  constexpr int H = Un::kHold, W = Un::kWidth;
  __shared__ double red[kCgWarps];
  __shared__ double slot[2][kCluster];
  cg_start();
  const unsigned rank = cluster_rank();
  const bool up = *active;
  const T rz0 = *rz;
  const Span<T, PATH> sp(n, p, rank);
  const T *p_ = p + sp.h, *a_ = ap + sp.h;
  T *x_ = x + sp.h, *r_ = r + sp.h;
  // the first pass's units of p and Ap, then of x and r: all loads
  // issued at once, the dot's first
  U hp[H], ha[H], hx[H], hr[H];
#pragma unroll
  for (int u = 0; u < H; ++u) {
    const long long i = sp.tid + u * sp.nth;
    if (i < sp.nv) {
      hp[u] = load_unit<U>(p_, i);
      ha[u] = load_unit<U>(a_, i);
    }
  }
#pragma unroll
  for (int u = 0; u < H; ++u) {
    const long long i = sp.tid + u * sp.nth;
    if (i < sp.nv) {
      hx[u] = load_unit<U>(x_, i);
      hr[u] = load_unit<U>(r_, i);
    }
  }
  // p.Ap: the later passes, the first, the head, the tail
  double acc = 0.0;
  for (long long b = sp.cap; b < sp.nv; b += sp.cap) {
#pragma unroll
    for (int u = 0; u < H; ++u) {
      const long long i = b + sp.tid + u * sp.nth;
      if (i < sp.nv) {
        const U a = load_unit<U>(p_, i), c = load_unit<U>(a_, i);
#pragma unroll
        for (int w = 0; w < W; ++w)
          acc = __dadd_rn(acc, prod64(Un::get(a, w), Un::get(c, w)));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < H; ++u) {
    if (sp.tid + u * sp.nth < sp.nv) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        acc = __dadd_rn(acc, prod64(Un::get(hp[u], w), Un::get(ha[u], w)));
    }
  }
  if (sp.tid < sp.h) acc = __dadd_rn(acc, prod64(p[sp.tid], ap[sp.tid]));
  if (sp.t0 + sp.tid < n)
    acc = __dadd_rn(acc, prod64(p[sp.t0 + sp.tid], ap[sp.t0 + sp.tid]));
  if (!up) return;                      // the same flag in every CTA
  const T d = round_to<T>(cluster_sum_all(acc, red, slot[0], rank));
  const T alpha = R::div(rz0, clamp_tiny(d));
  // the updates and ||r_new||^2 in the same order as p.Ap's passes
  double acc2 = 0.0;
  auto step = [&](T xv, T rv, T pv, T av, T& xo, T& ro) {
    xo = R::add(xv, R::mul(alpha, pv));
    ro = R::sub(rv, R::mul(alpha, av));
    acc2 = __dadd_rn(acc2, prod64(ro, ro));
  };
#pragma unroll
  for (int u = 0; u < H; ++u) {
    const long long i = sp.tid + u * sp.nth;
    if (i < sp.nv) {
      U xo, ro;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        T a, c;
        step(Un::get(hx[u], w), Un::get(hr[u], w), Un::get(hp[u], w),
             Un::get(ha[u], w), a, c);
        Un::set(xo, w, a);
        Un::set(ro, w, c);
      }
      store_unit(x_, i, xo);
      store_unit(r_, i, ro);
    }
  }
  for (long long b = sp.cap; b < sp.nv; b += sp.cap) {
#pragma unroll
    for (int u = 0; u < H; ++u) {
      const long long i = b + sp.tid + u * sp.nth;
      if (i < sp.nv) {
        const U pv = load_unit<U>(p_, i), av = load_unit<U>(a_, i);
        const U xv = load_unit<U>(x_, i), rv = load_unit<U>(r_, i);
        U xo, ro;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          T a, c;
          step(Un::get(xv, w), Un::get(rv, w), Un::get(pv, w),
               Un::get(av, w), a, c);
          Un::set(xo, w, a);
          Un::set(ro, w, c);
        }
        store_unit(x_, i, xo);
        store_unit(r_, i, ro);
      }
    }
  }
  if (sp.tid < sp.h) {
    const long long i = sp.tid;
    step(x[i], r[i], p[i], ap[i], x[i], r[i]);
  }
  if (sp.t0 + sp.tid < n) {
    const long long i = sp.t0 + sp.tid;
    step(x[i], r[i], p[i], ap[i], x[i], r[i]);
  }
  const double rr = cluster_sum_rank0(acc2, red, slot[1], rank);
  if (rank == 0 && threadIdx.x == 0) {
    *pap = d;
    *rnorm = round_to<T>(__dsqrt_rn(rr));
  }
}

// rz_new = r.z, beta = rz_new / clamp(rz), p = z + beta p, rz = rz_new,
// k += 1: one cluster.
template <typename T, int PATH>
__global__ void __launch_bounds__(kCgThreads, 1)
cg_p(long long n, T* p, const T* z, const T* r,
     T* __restrict__ rz, long long* __restrict__ k,
     const bool* __restrict__ active) {
  using R = Rn<T>;
  using Un = Unit<T, PATH>;
  using U = typename Un::type;
  constexpr int H = Un::kHold, W = Un::kWidth;
  __shared__ double red[kCgWarps];
  __shared__ double slot[kCluster];
  cg_start();
  const unsigned rank = cluster_rank();
  const bool up = *active;
  const T rz0 = *rz;           // read by every CTA before the barrier
  const Span<T, PATH> sp(n, p, rank);
  T* p_ = p + sp.h;
  const T *z_ = z + sp.h, *r_ = r + sp.h;
  // the first pass's units of r and z, then of p
  U hr[H], hz[H], hp[H];
#pragma unroll
  for (int u = 0; u < H; ++u) {
    const long long i = sp.tid + u * sp.nth;
    if (i < sp.nv) {
      hr[u] = load_unit<U>(r_, i);
      hz[u] = load_unit<U>(z_, i);
    }
  }
#pragma unroll
  for (int u = 0; u < H; ++u) {
    if (sp.tid + u * sp.nth < sp.nv)
      hp[u] = load_unit<U>(p_, sp.tid + u * sp.nth);
  }
  double acc = 0.0;
  for (long long b = sp.cap; b < sp.nv; b += sp.cap) {
#pragma unroll
    for (int u = 0; u < H; ++u) {
      const long long i = b + sp.tid + u * sp.nth;
      if (i < sp.nv) {
        const U a = load_unit<U>(r_, i), c = load_unit<U>(z_, i);
#pragma unroll
        for (int w = 0; w < W; ++w)
          acc = __dadd_rn(acc, prod64(Un::get(a, w), Un::get(c, w)));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < H; ++u) {
    if (sp.tid + u * sp.nth < sp.nv) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        acc = __dadd_rn(acc, prod64(Un::get(hr[u], w), Un::get(hz[u], w)));
    }
  }
  if (sp.tid < sp.h) acc = __dadd_rn(acc, prod64(r[sp.tid], z[sp.tid]));
  if (sp.t0 + sp.tid < n)
    acc = __dadd_rn(acc, prod64(r[sp.t0 + sp.tid], z[sp.t0 + sp.tid]));
  if (!up) return;
  const T rn = round_to<T>(cluster_sum_all(acc, red, slot, rank));
  const T beta = R::div(rn, clamp_tiny(rz0));
#pragma unroll
  for (int u = 0; u < H; ++u) {
    const long long i = sp.tid + u * sp.nth;
    if (i < sp.nv) {
      U po;
#pragma unroll
      for (int w = 0; w < W; ++w)
        Un::set(po, w, R::add(Un::get(hz[u], w),
                              R::mul(beta, Un::get(hp[u], w))));
      store_unit(p_, i, po);
    }
  }
  for (long long b = sp.cap; b < sp.nv; b += sp.cap) {
#pragma unroll
    for (int u = 0; u < H; ++u) {
      const long long i = b + sp.tid + u * sp.nth;
      if (i < sp.nv) {
        const U zv = load_unit<U>(z_, i), pv = load_unit<U>(p_, i);
        U po;
#pragma unroll
        for (int w = 0; w < W; ++w)
          Un::set(po, w, R::add(Un::get(zv, w),
                                R::mul(beta, Un::get(pv, w))));
        store_unit(p_, i, po);
      }
    }
  }
  if (sp.tid < sp.h) p[sp.tid] = R::add(z[sp.tid], R::mul(beta, p[sp.tid]));
  if (sp.t0 + sp.tid < n) {
    const long long i = sp.t0 + sp.tid;
    p[i] = R::add(z[i], R::mul(beta, p[i]));
  }
  if (rank == 0 && threadIdx.x == 0) {
    *rz = rn;
    *k += 1;
  }
}

// The stages, in the order of the pointer lists of kernels/krylov_update.py.
enum Stage { kBicgstabP = 0, kBicgstabS, kBicgstabXr, kCgXr, kCgP };
constexpr int kStages = kCgP + 1;
constexpr int kGridStages = kBicgstabXr + 1;  // the element loop's stages

// The vector path's kernel of a BiCGStab stage (the paths differ little
// in registers; the occupancy of one sizes all three).
template <typename T> const void* kernel_of(int stage) {
  const void* kernels[kGridStages] = {
      reinterpret_cast<const void*>(bicgstab_p<T, kVector>),
      reinterpret_cast<const void*>(bicgstab_s<T, kVector>),
      reinterpret_cast<const void*>(bicgstab_xr<T, kVector>)};
  return kernels[stage];
}

// f(std::integral_constant<int, path>) for the path given at run time.
template <typename F> void on_path(int path, F f) {
  if (path == kVector)
    f(std::integral_constant<int, kVector>());
  else if (path == kPeeled)
    f(std::integral_constant<int, kPeeled>());
  else
    f(std::integral_constant<int, kScalar>());
}

// The CTAs a card holds of the stage's kernel (SMs x CTAs per SM), once per
// device, dtype and stage.
template <typename T>
int resident(int stage, int* sms_out, int* cap_out) {
  constexpr int kDevices = 64;
  static int cache[kDevices][kGridStages][2] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kDevices && cache[dev][stage][1] > 0) {
    *sms_out = cache[dev][stage][0];
    *cap_out = cache[dev][stage][1];
    return 0;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_of<T>(stage), kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *sms_out = sms;
  *cap_out = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kDevices) {
    cache[dev][stage][0] = *sms_out;
    cache[dev][stage][1] = *cap_out;
  }
  return 0;
}

// One launch of the CG stage kernel K as one cluster of kCluster CTAs; a
// cluster above the portable 8 is allowed once per kernel and device.
template <auto K, typename... Args>
cudaError_t launch_cluster(cudaStream_t s, Args... args) {
  constexpr int kDevices = 64;
  static bool allowed[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (kCluster > 8 && (dev >= kDevices || !allowed[dev])) {
    e = cudaFuncSetAttribute(K, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
    if (dev < kDevices) allowed[dev] = true;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kCgThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, K, args...);
}

template <typename T>
int launch(int stage, void* const* a, long long n, int path, void* stream) {
  if (stage < 0 || stage >= kStages || path < kScalar || path > kPeeled)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto V = [&](int i) { return static_cast<T*>(a[i]); };
  auto B = [&](int i) { return static_cast<bool*>(a[i]); };
  if (stage == kCgXr || stage == kCgP) {
    cudaError_t e = cudaSuccess;
    switch (stage) {
      case kCgXr:
        on_path(path, [&](auto P) {
          e = launch_cluster<cg_xr<T, decltype(P)::value>>(
              s, n, V(0), V(1), V(2), V(3), V(4), V(5), V(6), B(7));
        });
        break;
      case kCgP:
        on_path(path, [&](auto P) {
          e = launch_cluster<cg_p<T, decltype(P)::value>>(
              s, n, V(0), V(1), V(2), V(3), static_cast<long long*>(a[4]),
              B(5));
        });
        break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  int sms = 0, cap = 0;
  const int rc = resident<T>(stage, &sms, &cap);
  if (rc != 0) return rc;
  // kUnroll 16-byte vectors per thread per trip (kUnroll * W elements on
  // the scalar path), in whole waves of the SMs, at most what the card
  // holds at once
  const long long per_cta = static_cast<long long>(kThreads) * kUnroll *
                            Vec<T>::kWidth;
  long long want = (n + per_cta - 1) / per_cta;
  want = (want + sms - 1) / sms * sms;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  switch (stage) {
    case kBicgstabP:
      on_path(path, [&](auto P) {
        bicgstab_p<T, decltype(P)::value><<<blocks, kThreads, 0, s>>>(
            n, V(0), V(1), V(2), V(3), V(4), V(5), V(6), V(7), B(8));
      });
      break;
    case kBicgstabS:
      on_path(path, [&](auto P) {
        bicgstab_s<T, decltype(P)::value><<<blocks, kThreads, 0, s>>>(
            n, V(0), V(1), V(2), V(3), V(4), V(5), V(6), B(7));
      });
      break;
    case kBicgstabXr:
      on_path(path, [&](auto P) {
        bicgstab_xr<T, decltype(P)::value><<<blocks, kThreads, 0, s>>>(
            n, V(0), V(1), V(2), V(3), V(4), V(5), V(6), V(7), V(8), V(9),
            V(10), V(11), V(12), V(13), B(14),
            static_cast<long long*>(a[15]), B(16));
      });
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One stage of a BiCGStab or CG iteration on n elements, its tensors'
// pointers in `args` (kernels/krylov_update.py gives each stage's list),
// on `path` (0 scalar, 1 vector, 2 peeled: kernels/krylov_update.path);
// returns the launch's cudaError_t, or -1 for an unknown stage or path.
int nst_krylov_update_f32(int stage, void* const* args, long long n,
                          int path, void* stream) {
  return launch<float>(stage, args, n, path, stream);
}

int nst_krylov_update_f64(int stage, void* const* args, long long n,
                          int path, void* stream) {
  return launch<double>(stage, args, n, path, stream);
}

// The CTAs of a CG stage's one thread-block cluster.
int nst_krylov_cg_cluster(void) { return kCluster; }

}  // extern "C"
