// The two-level V-cycle's Chebyshev smoother and residuals for Hopper
// (sm_90a): each stage is one SELL-C-sigma product with D = 1 (the row
// loop of csrc/sell_row.cuh, which csrc/sell_spmv.cu shares, so the
// product's bits are the SELL kernel's) followed by the stage's vector
// update at the product's row.
//
// Replaces no Pallas kernel: XLA's fusion of the JAX package's
// `schur.chebyshev` and `make_vcycle_solver` (navierstokes_tpu/solvers/
// schur.py:153-201), matvecs and axpys that eager PyTorch runs as one
// launch per line (about 85 per V-cycle at one cycle and k = 3).  The
// stages, on an assembled P1 operator S (kernels/vcycle.py drives them,
// one typed entry each; solvers/schur.py chains them into V-cycles):
//
//   first:      r0 = r - S x;  d = (sdinv * r0) / theta;  zc = d, where x
//               is the cycle's z, or z + P y with the coarse correction's
//               prolongation taken in the gather and at the row itself as
//               z[j] + y[j / agg] (written to znew); with no z the product
//               is skipped (r - S 0 is r bit for bit: every row sum of
//               zeros is +0) and r0 is r, not written;
//   first_last: the same x and d at k = 1, writing only out = x + d;
//   step:       resid = r0 - S zc;  d = c1 d + c2 (sdinv * resid);
//               zc' = zc + d;
//   step_last:  the same d and zc', writing only out = z + zc' (0 + zc'
//               with no z);
//   residual:   out = r - S x.

// theta, c1 = rho_new rho and c2 = 2 rho_new / delta are read from the
// coefficient vector the wrapper builds once per operator
// (kernels/vcycle.py `coefficients`, torch's own scalar expressions), so
// no scalar work runs inside a V-cycle.
//
// Rounding: every product, sum, difference and quotient is rounded on its
// own (__fmul_rn, __fadd_rn, __fdiv_rn and the double forms; a - b as
// a + (-b), which IEEE defines as the same), in the operand order of the
// plain version, so no multiply-add is contracted and each stage gives the
// bits of the torch operations it replaces (kernels/vcycle.py `*_plain`).
//
// Bound: device-memory traffic, as the product's: a slot's value and
// column (8 bytes in fp32) and a few vectors of n per row against a handful
// of flops.  At the P1 sizes of the step (113,378 rows at the bench point,
// 140,740 in 3D-1Z) the bytes take about 2-4 us, about the fixed cost of a
// launch, so the design removes launches: one per stage instead of one
// per torch operation, and every stage is launched with programmatic
// dependent launch (cudaLaunchKernelEx, programmatic stream serialization):
// its blocks are placed while the stage before drains and wait for it
// (griddepcontrol.wait) before their first read, then let the next stage
// be placed (griddepcontrol.launch_dependents).  One thread per row, one
// warp per slice, no shared memory, no atomics: repeated runs are
// bit-identical.
//
// Buffers: zc ping-pongs between two vectors (neighbouring rows read it);
// d and a last step's out = z + zc' are read and written at the thread's
// own row only, so they may be updated in place (z and out may alias).

#include <cuda_runtime.h>

#include "sell_row.cuh"

namespace {

using sell::kC;
constexpr int kThreads = 256;               // 8 slices per block
constexpr int kSlicesPerBlock = kThreads / kC;

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

// the row loop's gathers: x[c], and (z + P y)[c] = z[c] + y[c / agg]
template <typename T>
struct Gather {
  const T* x;
  __device__ void operator()(int c, T out[1]) const { out[0] = __ldg(x + c); }
};

template <typename T>
struct Prolonged {
  const T* z;
  const T* y;
  int agg;
  __device__ void operator()(int c, T out[1]) const {
    out[0] = Rn<T>::add(__ldg(z + c), __ldg(y + c / agg));
  }
};

// wait for the grid before (programmatic dependent launch), then let the
// next stage's blocks be placed
__device__ __forceinline__ void pdl_start() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" :::);
}

// the row of this thread and the sum of S x over it (Gather g), or false
// for a thread past the last slice or on a padding row; HasProduct false:
// no sum (acc 0)
template <typename T, bool HasProduct, typename Gather>
__device__ __forceinline__ bool row_product(const Sell<T>& s, Gather g,
                                            int& row, T& acc) {
  pdl_start();
  const int slice = blockIdx.x * kSlicesPerBlock + threadIdx.x / kC;
  if (slice >= s.n_slices) return false;
  const int lane = threadIdx.x % kC;
  T a[1] = {T(0)};
  if (HasProduct) {
    const int beg = s.slice_ptr[slice];
    const int width = (s.slice_ptr[slice + 1] - beg) / kC;
    sell::row_sum<T, 1>(s.vals, s.cols, beg, width, lane, g, a);
  }
  row = s.rows[slice * kC + lane];
  acc = a[0];
  return row >= 0;
}

// the first stage at this thread's row: x = z, or z + P y (Prolong), or 0
// (!HasZ), r0 = r - S x (r with no z) and d = (sdinv r0) / theta
template <typename T, bool HasZ, bool Prolong>
__device__ __forceinline__ bool first_row(const Sell<T>& s, const T* coef,
                                          const T* sdinv, const T* r,
                                          const T* z, const T* y, int agg,
                                          int& row, T& x, T& r0, T& d) {
  using R = Rn<T>;
  T acc;
  const bool live =
      Prolong ? row_product<T, true>(s, Prolonged<T>{z, y, agg}, row, acc)
              : row_product<T, HasZ>(s, Gather<T>{z}, row, acc);
  if (!live) return false;
  x = Prolong ? R::add(z[row], y[row / agg]) : HasZ ? z[row] : T(0);
  r0 = HasZ ? R::sub(r[row], acc) : r[row];
  d = R::div(R::mul(sdinv[row], r0), coef[0]);
  return true;
}

template <typename T, bool HasZ, bool Prolong>
__global__ void __launch_bounds__(kThreads)
    vcycle_first(Sell<T> s, const T* coef, const T* sdinv, const T* r,
                 const T* z, const T* y, int agg, T* r0, T* d, T* zc,
                 T* znew) {
  int row;
  T x, res, dv;
  if (!first_row<T, HasZ, Prolong>(s, coef, sdinv, r, z, y, agg, row, x,
                                   res, dv))
    return;
  if (HasZ) r0[row] = res;
  d[row] = dv;
  zc[row] = dv;
  if (Prolong) znew[row] = x;
}

template <typename T, bool HasZ, bool Prolong>
__global__ void __launch_bounds__(kThreads)
    vcycle_first_last(Sell<T> s, const T* coef, const T* sdinv, const T* r,
                      const T* z, const T* y, int agg, T* out) {
  int row;
  T x, res, dv;
  if (!first_row<T, HasZ, Prolong>(s, coef, sdinv, r, z, y, agg, row, x,
                                   res, dv))
    return;
  out[row] = Rn<T>::add(x, dv);
}

// iteration `step` at this thread's row: d' = c1 d + c2 (sdinv (r0 - S zc))
// and zc' = zc + d'
template <typename T>
__device__ __forceinline__ bool step_row(const Sell<T>& s, const T* coef,
                                         int step, const T* sdinv,
                                         const T* r0, const T* d,
                                         const T* zc, int& row, T& dv,
                                         T& zcv) {
  using R = Rn<T>;
  T acc;
  if (!row_product<T, true>(s, Gather<T>{zc}, row, acc)) return false;
  const T c1 = coef[1 + 2 * step];
  const T c2 = coef[2 + 2 * step];
  const T resid = R::sub(r0[row], acc);
  dv = R::add(R::mul(c1, d[row]), R::mul(c2, R::mul(sdinv[row], resid)));
  zcv = R::add(zc[row], dv);
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vcycle_step(Sell<T> s, const T* coef, int step, const T* sdinv,
                const T* r0, T* d, const T* zc, T* zc_out) {
  int row;
  T dv, zcv;
  if (!step_row<T>(s, coef, step, sdinv, r0, d, zc, row, dv, zcv)) return;
  d[row] = dv;
  zc_out[row] = zcv;
}

// out may alias z: each thread reads z at its own row before writing it
template <typename T, bool HasZ>
__global__ void __launch_bounds__(kThreads)
    vcycle_step_last(Sell<T> s, const T* coef, int step, const T* sdinv,
                     const T* r0, const T* d, const T* zc, const T* z,
                     T* out) {
  int row;
  T dv, zcv;
  if (!step_row<T>(s, coef, step, sdinv, r0, d, zc, row, dv, zcv)) return;
  out[row] = Rn<T>::add(HasZ ? z[row] : T(0), zcv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vcycle_residual(Sell<T> s, const T* r, const T* x, T* out) {
  int row;
  T acc;
  if (row_product<T, true>(s, Gather<T>{x}, row, acc))
    out[row] = Rn<T>::sub(r[row], acc);
}

// Launches K on the operator's slices with programmatic stream
// serialization; returns cudaGetLastError() after the launch.  Does not
// synchronise.
template <typename T, typename... Params, typename... Args>
int launch(void (*K)(Sell<T>, Params...), void* stream, const Sell<T>& s,
           Args... args) {
  if (s.n_slices <= 0) return 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((s.n_slices + kSlicesPerBlock - 1) / kSlicesPerBlock);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, K, s, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// z null: the stage at z = 0 (no product; y is not read)
template <typename T>
int first(Sell<T> s, const T* coef, const T* sdinv, const T* r, const T* z,
          const T* y, int agg, T* r0, T* d, T* zc, T* znew, void* stream) {
  if (z == nullptr)
    return launch(vcycle_first<T, false, false>, stream, s, coef, sdinv, r,
                  z, y, agg, r0, d, zc, znew);
  if (y != nullptr)
    return launch(vcycle_first<T, true, true>, stream, s, coef, sdinv, r, z,
                  y, agg, r0, d, zc, znew);
  return launch(vcycle_first<T, true, false>, stream, s, coef, sdinv, r, z,
                y, agg, r0, d, zc, znew);
}

template <typename T>
int first_last(Sell<T> s, const T* coef, const T* sdinv, const T* r,
               const T* z, const T* y, int agg, T* out, void* stream) {
  if (z == nullptr)
    return launch(vcycle_first_last<T, false, false>, stream, s, coef, sdinv,
                  r, z, y, agg, out);
  if (y != nullptr)
    return launch(vcycle_first_last<T, true, true>, stream, s, coef, sdinv,
                  r, z, y, agg, out);
  return launch(vcycle_first_last<T, true, false>, stream, s, coef, sdinv, r,
                z, y, agg, out);
}

template <typename T>
int step_last(Sell<T> s, const T* coef, int step, const T* sdinv,
              const T* r0, const T* d, const T* zc, const T* z, T* out,
              void* stream) {
  if (z == nullptr)
    return launch(vcycle_step_last<T, false>, stream, s, coef, step, sdinv,
                  r0, d, zc, z, out);
  return launch(vcycle_step_last<T, true>, stream, s, coef, step, sdinv, r0,
                d, zc, z, out);
}

}  // namespace

// One entry per stage and dtype (kernels/vcycle.py passes exactly these
// arguments): the operator's SELL arrays and slice count, then the stage's
// vectors; each returns 0 or the CUDA error of the launch.
#define NST_SELL(T)                                                      \
  const T *vals, const int *cols, const int *slice_ptr, const int *rows, \
      int n_slices
#define NST_VCYCLE_ENTRIES(T, SUFFIX)                                          \
  int nst_vcycle_first_##SUFFIX(NST_SELL(T), const T* coef, const T* sdinv,   \
                                const T* r, const T* z, const T* y, int agg,  \
                                T* r0, T* d, T* zc, T* znew, void* stream) {  \
    return first<T>({vals, cols, slice_ptr, rows, n_slices}, coef, sdinv, r,  \
                    z, y, agg, r0, d, zc, znew, stream);                      \
  }                                                                           \
  int nst_vcycle_first_last_##SUFFIX(NST_SELL(T), const T* coef,              \
                                     const T* sdinv, const T* r, const T* z,  \
                                     const T* y, int agg, T* out,             \
                                     void* stream) {                          \
    return first_last<T>({vals, cols, slice_ptr, rows, n_slices}, coef,       \
                         sdinv, r, z, y, agg, out, stream);                   \
  }                                                                           \
  int nst_vcycle_step_##SUFFIX(NST_SELL(T), const T* coef, int step,          \
                               const T* sdinv, const T* r0, T* d,             \
                               const T* zc, T* zc_out, void* stream) {        \
    return launch(vcycle_step<T>, stream,                                     \
                  Sell<T>{vals, cols, slice_ptr, rows, n_slices}, coef, step, \
                  sdinv, r0, d, zc, zc_out);                                  \
  }                                                                           \
  int nst_vcycle_step_last_##SUFFIX(NST_SELL(T), const T* coef, int step,     \
                                    const T* sdinv, const T* r0, const T* d,  \
                                    const T* zc, const T* z, T* out,          \
                                    void* stream) {                           \
    return step_last<T>({vals, cols, slice_ptr, rows, n_slices}, coef, step,  \
                        sdinv, r0, d, zc, z, out, stream);                    \
  }                                                                           \
  int nst_vcycle_residual_##SUFFIX(NST_SELL(T), const T* r, const T* x,       \
                                   T* out, void* stream) {                    \
    return launch(vcycle_residual<T>, stream,                                 \
                  Sell<T>{vals, cols, slice_ptr, rows, n_slices}, r, x, out); \
  }

extern "C" {
NST_VCYCLE_ENTRIES(float, f32)
NST_VCYCLE_ENTRIES(double, f64)
}  // extern "C"
