// SELL-C-sigma sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel navierstokes_tpu/ops/pallas_matvec.py
// `fused_reduce` (body `_kernel`), the multiply-reduce of the blocked-ELL F
// matvec, and serves every sparse operator of the step (F and the mass, G,
// B, the P1 Laplacian, Ap, the Schur diagonal, the PCD pressure
// convection) in the compact layout of ops/sell.py:
//
//   y[rows[l], d] = sum over j < w of vals[s(l, j)] * x[cols[s(l, j)], d]
//
// for lane l of a 32-row slice of width w, with slot
//   s(l, j) = ptr + (j / 4) * 128 + l * 4 + j % 4     for j < 4 * (w / 4),
//             ptr + (w / 4) * 128 + (j % 4) * 32 + l  for the w % 4 last.
//
// Bound: device-memory traffic.  A product reads one value and one int32
// column per slot (8 bytes in fp32) and does 2 * D flops on them, about
// 0.25 flop/byte against the card's ridge of about 295 in bf16 tensor-core
// work, so tensor cores have nothing to offer: the design only minimises
// and streams bytes.
//
// * The layout holds the nonzeros and little else (1.02 slots per nonzero
//   for F at the bench point).  The JAX package's blocked ELL, shaped for
//   the TPU's 128-lane axis, was 5% nonzero.
// * One thread per row, one warp per slice; each thread sums its slots in
//   slot order with one accumulator per component, rounding each product
//   and each sum (no fused multiply-add).  The order is fixed, with no
//   shuffles, shared memory or atomics, so repeated runs are bit-identical,
//   and it is the order of the plain version (kernels/sell_spmv.py), which
//   rounds the same way.  The row loop lives in csrc/sell_row.cuh, which
//   csrc/vcycle.cu shares, so the V-cycle's fused products keep these bits.
// * Values and columns arrive four slots at a time as one 16-byte load per
//   thread (8 bytes for bf16 values, two 16-byte loads for fp64), marked
//   streaming (__ldcs: evict first), so the gathered x, at most 7.2 MB,
//   stays in the 50 MB L2.  The group loop is unrolled twice, which keeps
//   eight slots of loads in flight per thread.
// * x is read as float2 / double2 for D = 2 (both velocity components of a
//   node in one load).  For D = 3 a row of x is 12 (24) bytes and starts
//   only 4 (8) bytes aligned, so it is read as three scalar loads; they
//   touch one or two 32-byte sectors, as one vector load would.  The output
//   row is written once.
//
// Three value types, one template:
//   fp32  values, x, sums and y in fp32 (the Pallas kernel's fp32 branch);
//   bf16  values read as bf16, each gathered x rounded to bf16, each product
//         rounded to bf16, sums and y in fp32 (the Pallas kernel's bf16
//         branch, pallas_matvec.py:53-57, and ops/bsr.py apply_f);
//   fp64  values, x, sums and y in double (no Pallas counterpart: float64
//         runs on the card and the refinement residual).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sell_row.cuh"

namespace {

using sell::Arith;
using sell::kC;
constexpr int kThreads = 256;  // 8 slices per block

template <typename T, int D>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  __device__ static void load(const T* x, int c, T out[1]) {
    out[0] = __ldg(x + c);
  }
  __device__ static void store(T* y, int r, const T v[1]) { y[r] = v[0]; }
};

template <>
struct Vec<float, 2> {
  __device__ static void load(const float* x, int c, float out[2]) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(x) + c);
    out[0] = t.x; out[1] = t.y;
  }
  __device__ static void store(float* y, int r, const float v[2]) {
    reinterpret_cast<float2*>(y)[r] = make_float2(v[0], v[1]);
  }
};

template <>
struct Vec<double, 2> {
  __device__ static void load(const double* x, int c, double out[2]) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(x) + c);
    out[0] = t.x; out[1] = t.y;
  }
  __device__ static void store(double* y, int r, const double v[2]) {
    reinterpret_cast<double2*>(y)[r] = make_double2(v[0], v[1]);
  }
};

// D = 3 (the 3D velocity): rows of x and y are three scalars apart, with no
// vector type of that width or alignment
template <typename T>
struct Vec<T, 3> {
  __device__ static void load(const T* x, int c, T out[3]) {
    const T* p = x + 3 * static_cast<long long>(c);
    out[0] = __ldg(p); out[1] = __ldg(p + 1); out[2] = __ldg(p + 2);
  }
  __device__ static void store(T* y, int r, const T v[3]) {
    T* p = y + 3 * static_cast<long long>(r);
    p[0] = v[0]; p[1] = v[1]; p[2] = v[2];
  }
};

// Vec's load as the row loop's gather of x
template <typename T, int D>
struct VecX {
  const T* x;
  __device__ void operator()(int c, T out[D]) const {
    Vec<T, D>::load(x, c, out);
  }
};

template <typename V, int D>
__global__ void __launch_bounds__(kThreads)
sell_spmv_kernel(const V* __restrict__ vals, const int* __restrict__ cols,
                 const int* __restrict__ slice_ptr,
                 const int* __restrict__ rows,
                 const typename Arith<V>::Acc* __restrict__ x,
                 typename Arith<V>::Acc* __restrict__ y, int n_slices) {
  using T = typename Arith<V>::Acc;
  const int slice = blockIdx.x * (kThreads / kC) + threadIdx.x / kC;
  if (slice >= n_slices) return;
  const int lane = threadIdx.x % kC;
  const int beg = slice_ptr[slice];
  const int width = (slice_ptr[slice + 1] - beg) / kC;
  T acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = T(0);
  sell::row_sum<V, D>(vals, cols, beg, width, lane, VecX<T, D>{x}, acc);
  const int row = rows[slice * kC + lane];
  if (row >= 0) Vec<T, D>::store(y, row, acc);
}

// Launches the D instantiation for value type V; returns cudaGetLastError()
// after the launch, or -1 for a D without an instantiation.  Does not
// synchronise.
template <typename V>
int dispatch(const void* vals, const int* cols, const int* slice_ptr,
             const int* rows, const void* x, void* y, int n_slices, int D,
             void* stream) {
  using T = typename Arith<V>::Acc;
  if (n_slices <= 0) return 0;
  const int blocks = (n_slices + kThreads / kC - 1) / (kThreads / kC);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const V* v = static_cast<const V*>(vals);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  if (D == 1) {
    sell_spmv_kernel<V, 1><<<blocks, kThreads, 0, st>>>(v, cols, slice_ptr,
                                                        rows, xx, yy, n_slices);
  } else if (D == 2) {
    sell_spmv_kernel<V, 2><<<blocks, kThreads, 0, st>>>(v, cols, slice_ptr,
                                                        rows, xx, yy, n_slices);
  } else if (D == 3) {
    sell_spmv_kernel<V, 3><<<blocks, kThreads, 0, st>>>(v, cols, slice_ptr,
                                                        rows, xx, yy, n_slices);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int nst_sell_spmv_f32(const float* vals, const int* cols, const int* slice_ptr,
                      const int* rows, const float* x, float* y, int n_slices,
                      int D, void* stream) {
  return dispatch<float>(vals, cols, slice_ptr, rows, x, y, n_slices, D,
                         stream);
}

// vals: bf16 (raw 16-bit storage); x, y: fp32
int nst_sell_spmv_bf16(const void* vals, const int* cols, const int* slice_ptr,
                       const int* rows, const float* x, float* y, int n_slices,
                       int D, void* stream) {
  return dispatch<__nv_bfloat16>(vals, cols, slice_ptr, rows, x, y, n_slices,
                                 D, stream);
}

int nst_sell_spmv_f64(const double* vals, const int* cols,
                      const int* slice_ptr, const int* rows, const double* x,
                      double* y, int n_slices, int D, void* stream) {
  return dispatch<double>(vals, cols, slice_ptr, rows, x, y, n_slices, D,
                          stream);
}

const char* nst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
