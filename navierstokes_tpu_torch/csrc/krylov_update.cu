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
//   cg_xr        alpha = rz / clamp(p.Ap), x += alpha p, r -= alpha Ap
//                (rz kept aside for cg_p)
//   cg_p         beta = rz_new / clamp(rz), p = z + beta p, rz, k
//
// Every state buffer (x, r, p, v, rho, alpha, omega, stag, rz, k) is
// written only while the loop's flag `active` is up, so an iteration run
// after the stop (krylov MASKED blocks) leaves the state bit-identical, as
// the plain body's `torch.where(active, new, old)` does.  Intermediates go
// to scratch (s, rz_prev).  No kernel reads a scalar that the same launch
// writes: a 0-d commit is one thread's store, and cg_p reads the rz that
// cg_xr set aside.
//
// Same bits as the plain body, in float and double: each product, sum,
// difference and quotient is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn and the __d*_rn forms), in torch's order, so nvcc
// contracts nothing into a fused multiply-add (the build leaves -fmad=true).
// torch's `a + b` and `a - b` on the card are `a + alpha * b` with
// alpha = +-1, exact before the one rounding, so they round as one add.
//
// Bound: bytes.  Each element is read and written once per stage (p: 3
// reads, 1 write; s: 2 and 2; x and r: 5 and 2; CG 4 and 2, then 2 and 1),
// a few flops each.  One element loop serves every stage, on one of three
// paths that the wrapper picks from the vectors' addresses (a pure
// function of their alignment, kernels/krylov_update.path):
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

template <typename T, int PATH>
__global__ void __launch_bounds__(kThreads)
cg_xr(long long n, T* x, T* r, const T* p, const T* ap,
      const T* __restrict__ rz, const T* __restrict__ pap,
      T* __restrict__ rz_prev, const bool* __restrict__ active) {
  using R = Rn<T>;
  __shared__ T sc;
  __shared__ bool up;
  T alpha;
  const T* in[4] = {x, r, p, ap};
  T* const out[2] = {x, r};
  auto ready = [&]() -> int {
    if (threadIdx.x == 0) {
      up = *active;
      const T rz0 = *rz;
      if (blockIdx.x == 0) *rz_prev = rz0;
      sc = R::div(rz0, clamp_tiny(*pap));
    }
    __syncthreads();
    alpha = sc;
    return up ? 3 : -1;
  };
  for_each<PATH, T, 4, 2>(n, in, out, ready, [&](const T* a, T* y) {
    y[0] = R::add(a[0], R::mul(alpha, a[2]));
    y[1] = R::sub(a[1], R::mul(alpha, a[3]));
  });
}

template <typename T, int PATH>
__global__ void __launch_bounds__(kThreads)
cg_p(long long n, T* p, const T* z,
     const T* __restrict__ rz_new, const T* __restrict__ rz_prev,
     T* __restrict__ rz, long long* __restrict__ k,
     const bool* __restrict__ active) {
  using R = Rn<T>;
  __shared__ T sc[2];
  __shared__ bool up;
  T beta;
  const T* in[2] = {p, z};
  T* const out[1] = {p};
  auto ready = [&]() -> int {
    if (threadIdx.x == 0) {
      up = *active;
      const T rn = *rz_new;
      sc[0] = R::div(rn, clamp_tiny(*rz_prev));
      if (up && blockIdx.x == 0) {
        *rz = rn;
        *k += 1;
      }
    }
    __syncthreads();
    beta = sc[0];
    return up ? 1 : -1;
  };
  for_each<PATH, T, 2, 1>(n, in, out, ready, [&](const T* a, T* y) {
    y[0] = R::add(a[1], R::mul(beta, a[0]));
  });
}

// The stages, in the order of the pointer lists of kernels/krylov_update.py.
enum Stage { kBicgstabP = 0, kBicgstabS, kBicgstabXr, kCgXr, kCgP };
constexpr int kStages = kCgP + 1;

// The vector path's kernel of a stage (the paths differ little in
// registers; the occupancy of one sizes all three).
template <typename T> const void* kernel_of(int stage) {
  const void* kernels[kStages] = {
      reinterpret_cast<const void*>(bicgstab_p<T, kVector>),
      reinterpret_cast<const void*>(bicgstab_s<T, kVector>),
      reinterpret_cast<const void*>(bicgstab_xr<T, kVector>),
      reinterpret_cast<const void*>(cg_xr<T, kVector>),
      reinterpret_cast<const void*>(cg_p<T, kVector>)};
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
  static int cache[kDevices][kStages][2] = {};
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

template <typename T>
int launch(int stage, void* const* a, long long n, int path, void* stream) {
  if (stage < 0 || stage >= kStages || path < kScalar || path > kPeeled)
    return -1;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto V = [&](int i) { return static_cast<T*>(a[i]); };
  auto B = [&](int i) { return static_cast<bool*>(a[i]); };
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
    case kCgXr:
      on_path(path, [&](auto P) {
        cg_xr<T, decltype(P)::value><<<blocks, kThreads, 0, s>>>(n, V(0), V(1), V(2), V(3),
                                                V(4), V(5), V(6), B(7));
      });
      break;
    case kCgP:
      on_path(path, [&](auto P) {
        cg_p<T, decltype(P)::value><<<blocks, kThreads, 0, s>>>(
            n, V(0), V(1), V(2), V(3), V(4), static_cast<long long*>(a[5]),
            B(6));
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

}  // extern "C"
