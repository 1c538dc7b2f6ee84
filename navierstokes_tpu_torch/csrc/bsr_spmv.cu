// Blocked-ELL sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel navierstokes_tpu/ops/pallas_matvec.py
// `fused_reduce` (body `_kernel`), which only fused the multiply-reduce of
// the BSR F matvec: the column gather had to stay outside it because
// Mosaic cannot lower `take`, and the overflow fold ran as a separate
// scatter.  Here one kernel does all three:
//
//   y[p, i, d] = sum over v in {p} + spill[p, :] (v < n_ext) of
//                sum_c vals[v, i, c] * x[(cols[v, c / cb] * cb + c % cb) * D + d]
//
// with vals in the flat row-major layout (n_ext, R, K*cb) shared by every
// blocked-ELL operator of the step (F, mass, G, B, the P1 Laplacian, the
// pressure convection).  `spill` (n_phys, S) lists the virtual overflow
// rows of each physical row; entries >= n_ext are dead.  The fold is a
// gather-sum in a fixed order, so there are no atomics and repeated runs
// are bit-identical.
//
// Three value types, one template:
//   fp32  values, x, sums and y in fp32 (the Pallas kernel's fp32 branch);
//   bf16  values read as bf16, each gathered x rounded to bf16, each product
//         rounded to bf16, sums and y in fp32 (the Pallas kernel's bf16
//         branch, pallas_matvec.py:53-57, and ops/bsr.py apply_f);
//   fp64  values, x, sums and y in double (no Pallas counterpart: float64
//         runs on the card and the refinement residual).
//
// Bound: device-memory traffic.  At the 1,014,414-DoF bench point the F
// values alone are 402 MB per product in fp32 (201 MB in bf16) against
// ~1.7 MB of gathered vector (2 flops per value).  The design therefore
// reads each value exactly once, for all D components: one thread block per
// physical row, threads across the value row's minor axis (coalesced reads),
// per-thread register accumulators for all (i, d), then one block reduction
// in a fixed tree order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;   // blockDim.x <= 256

// How a stored value meets a gathered x: Acc is the type of x, of the sums
// and of y.
template <typename V>
struct Arith;

template <>
struct Arith<float> {
  using Acc = float;
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float x_in(float x) { return x; }
  __device__ static float madd(float a, float x, float acc) {
    return fmaf(a, x, acc);
  }
};

template <>
struct Arith<double> {
  using Acc = double;
  __device__ static double load(const double* p) { return __ldg(p); }
  __device__ static double x_in(double x) { return x; }
  __device__ static double madd(double a, double x, double acc) {
    return fma(a, x, acc);
  }
};

template <>
struct Arith<__nv_bfloat16> {
  using Acc = float;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ushort_as_bfloat16(
        __ldg(reinterpret_cast<const unsigned short*>(p))));
  }
  __device__ static float x_in(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // a and xb hold bf16 values, so their fp32 product is exact and one
  // round-to-nearest-even to bf16 is the bf16 multiply
  __device__ static float madd(float a, float xb, float acc) {
    return acc + __bfloat162float(__float2bfloat16_rn(a * xb));
  }
};

template <typename V, int R, int D>
__global__ void __launch_bounds__(256)
bsr_spmv_kernel(const V* __restrict__ vals, const int* __restrict__ cols,
                const typename Arith<V>::Acc* __restrict__ x,
                const int* __restrict__ spill,
                typename Arith<V>::Acc* __restrict__ y, int n_ext, int K,
                int cb, int S) {
  using A = Arith<V>;
  using T = typename A::Acc;
  const int p = blockIdx.x;
  const int C = K * cb;
  T acc[R][D];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int d = 0; d < D; ++d) acc[i][d] = T(0);

  // own row first, then the spill rows in table order (block-uniform)
  for (int s = -1; s < S; ++s) {
    const int v = (s < 0) ? p : spill[(size_t)p * S + s];
    if (v >= n_ext) continue;
    const V* vrow = vals + (size_t)v * R * C;
    const int* crow = cols + (size_t)v * K;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const int k = c / cb;
      const size_t xi = ((size_t)crow[k] * cb + (c - k * cb)) * D;
      T xg[D];
#pragma unroll
      for (int d = 0; d < D; ++d) xg[d] = A::x_in(__ldg(x + xi + d));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const T a = A::load(vrow + (size_t)i * C + c);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[i][d] = A::madd(a, xg[d], acc[i][d]);
      }
    }
  }

  // block reduction: butterfly within each warp, then warps in order
  __shared__ T part[kMaxWarps][R * D];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int d = 0; d < D; ++d) {
      T t = acc[i][d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t += __shfl_xor_sync(0xffffffffu, t, off);
      if (lane == 0) part[warp][i * D + d] = t;
    }
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  for (int j = threadIdx.x; j < R * D; j += blockDim.x) {
    T t = T(0);
    for (int w = 0; w < n_warps; ++w) t += part[w][j];
    y[(size_t)p * R * D + j] = t;
  }
}

// Launches the (R, D) instantiation for value type V; returns
// cudaGetLastError() after the launch, or -1 for an (R, D) pair without an
// instantiation.  Does not synchronise.
template <typename V>
int dispatch(const void* vals, const int* cols, const void* x,
             const int* spill, void* y, int n_phys, int n_ext, int R, int K,
             int cb, int D, int S, void* stream) {
  using T = typename Arith<V>::Acc;
  const int C = K * cb;
  int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const V* v = static_cast<const V*>(vals);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
#define NST_CASE(r, d)                                                   \
  if (R == r && D == d) {                                                \
    bsr_spmv_kernel<V, r, d><<<n_phys, threads, 0, st>>>(                \
        v, cols, xx, spill, yy, n_ext, K, cb, S);                        \
    return static_cast<int>(cudaGetLastError());                         \
  }
  NST_CASE(8, 1) NST_CASE(8, 2)
  NST_CASE(16, 1) NST_CASE(16, 2)
  NST_CASE(32, 1) NST_CASE(32, 2)
  NST_CASE(64, 1)
#undef NST_CASE
  return -1;
}

}  // namespace

extern "C" {

int nst_bsr_spmv_f32(const float* vals, const int* cols, const float* x,
                     const int* spill, float* y, int n_phys, int n_ext, int R,
                     int K, int cb, int D, int S, void* stream) {
  return dispatch<float>(vals, cols, x, spill, y, n_phys, n_ext, R, K, cb, D,
                         S, stream);
}

// vals: bf16 (raw 16-bit storage); x, y: fp32
int nst_bsr_spmv_bf16(const void* vals, const int* cols, const float* x,
                      const int* spill, float* y, int n_phys, int n_ext,
                      int R, int K, int cb, int D, int S, void* stream) {
  return dispatch<__nv_bfloat16>(vals, cols, x, spill, y, n_phys, n_ext, R,
                                 K, cb, D, S, stream);
}

int nst_bsr_spmv_f64(const double* vals, const int* cols, const double* x,
                     const int* spill, double* y, int n_phys, int n_ext,
                     int R, int K, int cb, int D, int S, void* stream) {
  return dispatch<double>(vals, cols, x, spill, y, n_phys, n_ext, R, K, cb, D,
                          S, stream);
}

const char* nst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
