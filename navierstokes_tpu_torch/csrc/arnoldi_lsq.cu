// FGMRES's Givens update on the card (sm_90a): one Arnoldi iteration's step
// of the Hessenberg least-squares problem of solvers/krylov.py `gmres`.
//
// Replaces no Pallas kernel.  The JAX package runs this algebra inside its
// `lax.while_loop` (navierstokes_tpu/solvers/krylov.py:108-126, the
// `fori_loop(rot_body)` and the new rotation).  Eager PyTorch would spend
// O(j) tiny launches per iteration on it, or a round trip to the host;
// here each step is one launch that reads everything that varies from
// device memory: j, the flag, the target and the cycle's bound j_max.  So
// one captured while node serves every cycle of every solve (the outer
// solve and refinement's corrections; models/step_graphs.py).  Given the
// node's handle, it also sets the node's condition from the flag it
// writes, and counts the evaluation in the node's tally, as
// csrc/graph_cond.cu's set_condition does: FGMRES's body then needs no
// launch of its own for its predicate.  The cycle's triangular solve
// stays on the host (kernels/arnoldi_lsq.py says why).
//
// Bound: the launch, now a node inside a CUDA graph (PERF.md gives its
// in-graph time per launch).  The algebra is serial (rotation i changes
// the entry rotation i + 1 reads) and at most m + 1 = 65 values long at
// the default restart, a few hundred flops and under 34 KB in fp64, so
// one CTA runs it: its threads stage the column h1 + h2 in shared memory
// and write H[:, j], thread 0 does the serial part.
//
// The arithmetic is the plain version's (kernels/arnoldi_lsq.py), op for
// op: every product, sum, quotient and square root is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn and the __d*_rn forms), so
// nvcc contracts nothing into a fused multiply-add, and equals the host
// arithmetic it replaces bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T> struct Rn;

template <> struct Rn<float> {
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <> struct Rn<double> {
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// H (m+1, m) row-major, cs, sn (m), g (m+1), h1, h2 (m+1) the two
// Gram-Schmidt passes' coefficients; while *active: h = h1 + h2,
// h[j+1] = *wnorm, rotations 0..j-1, the new rotation j, g rotated,
// H[:, j] = h, *res = |g[j+1]|, *j += 1,
// *active = (*j < *j_max) && (*res > *target); with use_handle, the
// while node's condition set to the new flag, and tally (null, or the
// node's three counters) advanced as set_condition advances it.
template <typename T>
__global__ void lsq_update_kernel(T* __restrict__ H, T* __restrict__ cs,
                                  T* __restrict__ sn, T* __restrict__ g,
                                  const T* __restrict__ h1,
                                  const T* __restrict__ h2,
                                  const T* __restrict__ wnorm,
                                  int* __restrict__ j_ptr,
                                  T* __restrict__ res,
                                  bool* __restrict__ active,
                                  const T* __restrict__ target,
                                  const int* __restrict__ j_max, int m,
                                  cudaGraphConditionalHandle handle,
                                  int use_handle,
                                  long long* __restrict__ tally) {
  using R = Rn<T>;
  extern __shared__ unsigned char smem_raw[];
  T* col = reinterpret_cast<T*>(smem_raw);
  if (!*active) {                  // the same for every thread
    if (threadIdx.x == 0) {
      if (use_handle) cudaGraphSetConditional(handle, 0u);
      if (tally != nullptr) {
        tally[0] += 1;
        tally[2] += 1;             // a body run under a down flag
      }
    }
    return;
  }
  const int j = *j_ptr;
  for (int i = threadIdx.x; i <= m; i += blockDim.x)
    col[i] = R::add(h1[i], h2[i]);
  __syncthreads();
  if (threadIdx.x == 0) {
    col[j + 1] = *wnorm;
    for (int i = 0; i < j; ++i) {
      const T c = cs[i], s = sn[i];
      const T hi = R::add(R::mul(c, col[i]), R::mul(s, col[i + 1]));
      col[i + 1] = R::add(R::mul(-s, col[i]), R::mul(c, col[i + 1]));
      col[i] = hi;
    }
    const T a = col[j], b = col[j + 1];
    const T denom = R::sqrt(R::add(R::mul(a, a), R::mul(b, b)));
    T cj = T(1), sj = T(0);
    if (denom > T(0)) {
      const T d = denom > T(1e-30) ? denom : T(1e-30);
      cj = R::div(a, d);
      sj = R::div(b, d);
    }
    col[j] = denom;
    col[j + 1] = T(0);
    cs[j] = cj;
    sn[j] = sj;
    const T gj = g[j];
    g[j + 1] = R::mul(-sj, gj);
    g[j] = R::mul(cj, gj);
    const T r = fabs(g[j + 1]);
    *res = r;
    *j_ptr = j + 1;
    const bool up = (j + 1 < *j_max) && (r > *target);
    *active = up;
    if (use_handle) cudaGraphSetConditional(handle, up ? 1u : 0u);
    if (tally != nullptr) {
      tally[0] += 1;
      tally[1] += up ? 1 : 0;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= m; i += blockDim.x) H[i * m + j] = col[i];
}

template <typename T>
int update(void* H, void* cs, void* sn, void* g, const void* h1,
           const void* h2, const void* wnorm, int* j, void* res,
           bool* active, const void* target, const int* j_max, int m,
           void* stream, unsigned long long handle, int use_handle,
           long long* tally) {
  const size_t smem = static_cast<size_t>(m + 1) * sizeof(T);
  lsq_update_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(H), static_cast<T*>(cs), static_cast<T*>(sn),
      static_cast<T*>(g), static_cast<const T*>(h1),
      static_cast<const T*>(h2), static_cast<const T*>(wnorm), j,
      static_cast<T*>(res), active, static_cast<const T*>(target), j_max,
      m, static_cast<cudaGraphConditionalHandle>(handle), use_handle, tally);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int nst_lsq_update_f32(void* H, void* cs, void* sn, void* g, const void* h1,
                       const void* h2, const void* wnorm, int* j, void* res,
                       bool* active, const void* target, const int* j_max,
                       int m, void* stream, unsigned long long handle,
                       int use_handle, long long* tally) {
  return update<float>(H, cs, sn, g, h1, h2, wnorm, j, res, active, target,
                       j_max, m, stream, handle, use_handle, tally);
}

int nst_lsq_update_f64(void* H, void* cs, void* sn, void* g, const void* h1,
                       const void* h2, const void* wnorm, int* j, void* res,
                       bool* active, const void* target, const int* j_max,
                       int m, void* stream, unsigned long long handle,
                       int use_handle, long long* tally) {
  return update<double>(H, cs, sn, g, h1, h2, wnorm, j, res, active,
                        target, j_max, m, stream, handle, use_handle, tally);
}

}  // extern "C"
