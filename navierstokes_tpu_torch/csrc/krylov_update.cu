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
// a few flops each; the scalars are 0-d loads that every thread makes
// from the L1.  Scalar (4- or 8-byte) loads, one element per thread in a
// grid-stride loop: the vectors may be views of a flat (u, p) vector that
// sit 4 or 8 bytes off a 16-byte boundary.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
bicgstab_p(long long n, T* __restrict__ p, const T* __restrict__ r,
           const T* __restrict__ v, const T* __restrict__ rho_new,
           const T* __restrict__ rho, const T* __restrict__ alpha,
           const T* __restrict__ omega, const T* __restrict__ eps,
           const bool* __restrict__ active) {
  using R = Rn<T>;
  if (!*active) return;
  const T e = *eps, om = *omega;
  const T beta = R::mul(R::div(*rho_new, guard(*rho, e)),
                        R::div(*alpha, guard(om, e)));
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    p[i] = R::add(r[i], R::mul(beta, R::sub(p[i], R::mul(om, v[i]))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bicgstab_s(long long n, T* __restrict__ s, T* __restrict__ v_state,
           const T* __restrict__ r, const T* __restrict__ v,
           const T* __restrict__ rho_new, const T* __restrict__ denom,
           const T* __restrict__ eps, const bool* __restrict__ active) {
  using R = Rn<T>;
  const bool up = *active;
  const T alpha = R::div(*rho_new, guard(*denom, *eps));
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const T vi = v[i];
    s[i] = R::sub(r[i], R::mul(alpha, vi));
    if (up) v_state[i] = vi;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bicgstab_xr(long long n, T* __restrict__ x, T* __restrict__ r,
            const T* __restrict__ phat, const T* __restrict__ shat,
            const T* __restrict__ s, const T* __restrict__ t,
            const T* __restrict__ rho_new, const T* __restrict__ denom,
            const T* __restrict__ ts, const T* __restrict__ tt,
            const T* __restrict__ eps, T* __restrict__ rho,
            T* __restrict__ alpha_state, T* __restrict__ omega_state,
            bool* __restrict__ stag, long long* __restrict__ k,
            const bool* __restrict__ active) {
  using R = Rn<T>;
  if (!*active) return;
  const T e = *eps, rn = *rho_new, dn = *denom, t2 = *tt;
  const T alpha = R::div(rn, guard(dn, e));
  const T omega = R::div(*ts, t2 > e ? t2 : e);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    x[i] = R::add(R::add(x[i], R::mul(alpha, phat[i])),
                  R::mul(omega, shat[i]));
    r[i] = R::sub(s[i], R::mul(omega, t[i]));
  }
  if (first_thread()) {
    *rho = rn;
    *alpha_state = alpha;
    *omega_state = omega;
    *stag = fabs(rn) <= e || fabs(dn) <= e;
    *k += 1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_xr(long long n, T* __restrict__ x, T* __restrict__ r,
      const T* __restrict__ p, const T* __restrict__ ap,
      const T* __restrict__ rz, const T* __restrict__ pap,
      T* __restrict__ rz_prev, const bool* __restrict__ active) {
  using R = Rn<T>;
  const T rz0 = *rz;
  if (first_thread()) *rz_prev = rz0;
  if (!*active) return;
  const T alpha = R::div(rz0, clamp_tiny(*pap));
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    x[i] = R::add(x[i], R::mul(alpha, p[i]));
    r[i] = R::sub(r[i], R::mul(alpha, ap[i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_p(long long n, T* __restrict__ p, const T* __restrict__ z,
     const T* __restrict__ rz_new, const T* __restrict__ rz_prev,
     T* __restrict__ rz, long long* __restrict__ k,
     const bool* __restrict__ active) {
  using R = Rn<T>;
  if (!*active) return;
  const T rn = *rz_new;
  const T beta = R::div(rn, clamp_tiny(*rz_prev));
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    p[i] = R::add(z[i], R::mul(beta, p[i]));
  if (first_thread()) {
    *rz = rn;
    *k += 1;
  }
}

// The stages, in the order of the pointer lists of kernels/krylov_update.py.
enum Stage { kBicgstabP = 0, kBicgstabS, kBicgstabXr, kCgXr, kCgP };

template <typename T>
int launch(int stage, void* const* a, long long n, void* stream) {
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 ? 1
                                      : (want < kMaxBlocks ? want
                                                           : kMaxBlocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto V = [&](int i) { return static_cast<T*>(a[i]); };
  auto B = [&](int i) { return static_cast<bool*>(a[i]); };
  switch (stage) {
    case kBicgstabP:
      bicgstab_p<T><<<blocks, kThreads, 0, s>>>(n, V(0), V(1), V(2), V(3),
                                                V(4), V(5), V(6), V(7), B(8));
      break;
    case kBicgstabS:
      bicgstab_s<T><<<blocks, kThreads, 0, s>>>(n, V(0), V(1), V(2), V(3),
                                                V(4), V(5), V(6), B(7));
      break;
    case kBicgstabXr:
      bicgstab_xr<T><<<blocks, kThreads, 0, s>>>(
          n, V(0), V(1), V(2), V(3), V(4), V(5), V(6), V(7), V(8), V(9),
          V(10), V(11), V(12), V(13), B(14),
          static_cast<long long*>(a[15]), B(16));
      break;
    case kCgXr:
      cg_xr<T><<<blocks, kThreads, 0, s>>>(n, V(0), V(1), V(2), V(3), V(4),
                                           V(5), V(6), B(7));
      break;
    case kCgP:
      cg_p<T><<<blocks, kThreads, 0, s>>>(n, V(0), V(1), V(2), V(3), V(4),
                                          static_cast<long long*>(a[5]),
                                          B(6));
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One stage of a BiCGStab or CG iteration on n elements, its tensors'
// pointers in `args` (kernels/krylov_update.py gives each stage's list);
// returns the launch's cudaError_t, or -1 for an unknown stage.
int nst_krylov_update_f32(int stage, void* const* args, long long n,
                          void* stream) {
  return launch<float>(stage, args, n, stream);
}

int nst_krylov_update_f64(int stage, void* const* args, long long n,
                          void* stream) {
  return launch<double>(stage, args, n, stream);
}

}  // extern "C"
