// FGMRES's two-pass modified Gram-Schmidt on the card (sm_90a), over the
// live rows of the basis only.
//
// Replaces no Pallas kernel: the JAX package's Arnoldi step runs the two
// passes "vectorized over the full static basis with an index mask"
// (navierstokes_tpu/solvers/krylov.py:95-103), which XLA fuses; the port's
// plain version (kernels/gram_schmidt.py) runs them as four products over
// all m + 1 rows of V, (m + 1, n), although rows j + 1..m are zero.  Here
// j is read from the device, so no launch argument varies between
// iterations or cycles (one captured while body serves every cycle, as
// with csrc/arnoldi_lsq.cu), and only rows 0..j are read:
//
//   gs_pass<0>    per CTA tile of 256 elements, the partial dots of rows
//                 0..j with w;
//   gs_reduce     h1[i] = the partials of row i summed in a fixed order,
//                 rounded once; 0 beyond j (the mask's zeros);
//   gs_pass<1>    w1 = w - sum_i h1[i] V[i] on the tile, and the partial
//                 dots of rows 0..j with w1 on the same tile;
//   gs_reduce     h2 likewise;
//   gs_pass<2>    w2 = w1 - sum_i h2[i] V[i], and the tile's partial sum
//                 of w2^2;
//   gs_finish     every CTA sums the norm's partials in the same fixed
//                 order, ||w2|| = sqrt of it (CTA 0 stores it), and while
//                 `active`: V[min(j+1, m)] = w2 / max(||w2||, 1e-30) and,
//                 for FGMRES, Z[min(j, m-1)] = z.
//
// Every product is summed in float64, for float32 data too: a product of
// two floats is exact there, so the result rounded once to float hardly
// depends on the order of the sum, and the plain version, which sums in
// float64 in BLAS's order, agrees with it to within an ulp.  The order
// here is fixed (lane FMAs over the tile, a xor butterfly per warp, the
// CTA partials in index order): no atomics, the same bits on every run.
// w itself is not written (w1 and w2 go to a scratch vector).
//
// Bound: bytes.  The function reads rows 0..j of V, w and z once and
// writes one row of V and of Z; the two dependent passes make this design
// read rows 0..j three times from device memory, plus w and the scratch
// vector, about 3 (j + 1) + 7 rows of n.  A pass stages its tile's rows
// kBlock at a time with cp.async (4- or 8-byte copies: a row of the flat
// vector is only element-aligned) into a fixed 17 KB (float) or 35 KB
// (double) of shared memory, whatever j, so the CTAs a card holds do not
// depend on the restart length.  gs_pass<1>'s dots take the blocks in
// reverse: the last block is still staged from the update, the others
// are read again, from the L2 (the CTA read them just before).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;                // elements per CTA
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 16;                // rows staged at a time
constexpr int kFinishCtas = 264;

template <typename T> __device__ T to_t(double a);
template <> __device__ float to_t<float>(double a) {
  return __double2float_rn(a);
}
template <> __device__ double to_t<double>(double a) { return a; }

__device__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

__device__ double warp_sum(double a) {
  for (int o = 16; o > 0; o >>= 1)
    a = __dadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

// The CTA's sum, in thread 0: warp sums, then the warps in order.
__device__ double cta_sum(double a, double* red) {
  a = warp_sum(a);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s = __dadd_rn(s, red[w]);
  return s;
}

__device__ int live_rows(const int* j_ptr, int m) {
  const int j = *j_ptr;
  return (j < m ? j : m) + 1;
}

// Thread t's element of rows b..b+nb-1 of the tile into sv (zeros past
// the end of V), asynchronously; each thread waits for its own copies.
template <typename T>
__device__ void stage(T* sv, const T* __restrict__ V, int b, int nb,
                      long long n, long long k0, int cnt) {
  const int t = threadIdx.x;
  for (int i = 0; i < nb; ++i) {
    T* dst = sv + i * kTile + t;
    if (t < cnt)
      __pipeline_memcpy_async(dst, V + (b + i) * n + k0 + t, sizeof(T));
    else
      *dst = T(0);
  }
  __pipeline_commit();
}

// MODE 0: part[i][cta] = tile dot of V[i] and win, i <= j.
// MODE 1: wout = win - sum_i h[i] V[i] on the tile; then MODE 0's dots
//         with wout.
// MODE 2: wout = win - sum_i h[i] V[i]; part[cta] = the tile's sum of
//         wout^2.  (win and wout may be the same vector: each thread reads
//         its element before writing it.)
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
gs_pass(const T* __restrict__ V, const T* win, T* wout,
        const T* __restrict__ h, double* __restrict__ part,
        const int* __restrict__ j_ptr, int m, long long n) {
  __shared__ __align__(16) T sv[kBlock * kTile];
  __shared__ T sw[kTile];
  __shared__ double red[kWarps];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long k0 = static_cast<long long>(blockIdx.x) * kTile;
  const int cnt = n - k0 < kTile ? static_cast<int>(n - k0) : kTile;
  const int rows = live_rows(j_ptr, m);
  const int blocks = (rows + kBlock - 1) / kBlock;
  T wt = t < cnt ? win[k0 + t] : T(0);
  if (MODE != 0) {
    // each thread reads only the elements it staged: no barrier
    double acc = 0.0;
    for (int b = 0; b < rows; b += kBlock) {
      const int nb = rows - b < kBlock ? rows - b : kBlock;
      stage(sv, V, b, nb, n, k0, cnt);
      __pipeline_wait_prior(0);
      for (int i = 0; i < nb; ++i)
        acc = __fma_rn(static_cast<double>(h[b + i]),
                       static_cast<double>(sv[i * kTile + t]), acc);
    }
    wt = to_t<T>(__dsub_rn(static_cast<double>(wt), acc));
    if (t < cnt) wout[k0 + t] = wt;
  }
  if (MODE != 2) {
    sw[t] = wt;
    for (int q = 0; q < blocks; ++q) {
      const int b = (MODE == 1 ? blocks - 1 - q : q) * kBlock;
      const int nb = rows - b < kBlock ? rows - b : kBlock;
      if (MODE != 1 || q > 0) {
        __syncthreads();              // the previous block's dots are done
        stage(sv, V, b, nb, n, k0, cnt);
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      for (int i = warp; i < nb; i += kWarps) {
        const T* row = sv + i * kTile;
        double a = 0.0;
#pragma unroll
        for (int c = 0; c < kTile / 32; ++c) {
          const int e = lane + 32 * c;
          a = __fma_rn(static_cast<double>(row[e]),
                       static_cast<double>(sw[e]), a);
        }
        a = warp_sum(a);
        if (lane == 0)
          part[static_cast<long long>(b + i) * gridDim.x + blockIdx.x] = a;
      }
    }
  } else {
    const double q = __dmul_rn(static_cast<double>(wt),
                               static_cast<double>(wt));
    const double s = cta_sum(q, red);
    if (t == 0) part[blockIdx.x] = s;
  }
}

// h[i] = the n_parts partials of row i summed in index order (strided over
// the threads, then cta_sum), rounded once; h[i] = 0 for i > j.  One CTA
// per row 0..m.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gs_reduce(const double* __restrict__ part, T* __restrict__ h,
          const int* __restrict__ j_ptr, int m, int n_parts) {
  __shared__ double red[kWarps];
  const int i = blockIdx.x;
  if (i >= live_rows(j_ptr, m)) {
    if (threadIdx.x == 0) h[i] = T(0);
    return;
  }
  double a = 0.0;
  for (int b = threadIdx.x; b < n_parts; b += kThreads)
    a = __dadd_rn(a, part[static_cast<long long>(i) * n_parts + b]);
  const double s = cta_sum(a, red);
  if (threadIdx.x == 0) h[i] = to_t<T>(s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gs_finish(T* __restrict__ V, const T* __restrict__ w, T* __restrict__ wnorm,
          const double* __restrict__ part, const int* __restrict__ j_ptr,
          const bool* __restrict__ active, const T* __restrict__ z,
          T* __restrict__ Z, int m, long long n, int n_parts) {
  __shared__ double red[kWarps];
  __shared__ double total;
  double a = 0.0;
  for (int b = threadIdx.x; b < n_parts; b += kThreads)
    a = __dadd_rn(a, part[b]);
  const double s = cta_sum(a, red);
  if (threadIdx.x == 0) total = s;
  __syncthreads();
  const T wn = to_t<T>(__dsqrt_rn(total));
  if (blockIdx.x == 0 && threadIdx.x == 0) *wnorm = wn;
  if (!*active) return;
  // torch.clamp(wnorm, min=1e-30): NaN passes through
  const T lo = T(1e-30);
  const T d = isnan(wn) ? wn : (wn < lo ? lo : wn);
  const int j = *j_ptr;
  T* vrow = V + static_cast<long long>(j + 1 < m ? j + 1 : m) * n;
  T* zrow = Z == nullptr ? nullptr
                         : Z + static_cast<long long>(j < m - 1 ? j : m - 1) * n;
  for (long long k = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       k < n; k += static_cast<long long>(gridDim.x) * kThreads) {
    vrow[k] = div_rn(w[k], d);
    if (zrow != nullptr) zrow[k] = z[k];
  }
}

template <typename T>
int run(const void* V_, const void* w_, void* h1_, void* h2_, void* wnorm_,
        const int* j, const bool* active, const void* z_, void* Z_,
        double* part, void* wbuf_, int m, long long n, void* stream) {
  if (m < 1 || n < 1) return -1;
  const T* V = static_cast<const T*>(V_);
  const T* w = static_cast<const T*>(w_);
  T* h1 = static_cast<T*>(h1_);
  T* h2 = static_cast<T*>(h2_);
  T* wbuf = static_cast<T*>(wbuf_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = static_cast<int>((n + kTile - 1) / kTile);
  gs_pass<T, 0><<<parts, kThreads, 0, s>>>(V, w, nullptr, nullptr, part, j,
                                           m, n);
  gs_reduce<T><<<m + 1, kThreads, 0, s>>>(part, h1, j, m, parts);
  gs_pass<T, 1><<<parts, kThreads, 0, s>>>(V, w, wbuf, h1, part, j, m, n);
  gs_reduce<T><<<m + 1, kThreads, 0, s>>>(part, h2, j, m, parts);
  gs_pass<T, 2><<<parts, kThreads, 0, s>>>(V, wbuf, wbuf, h2, part, j, m, n);
  gs_finish<T><<<parts < kFinishCtas ? parts : kFinishCtas, kThreads, 0, s>>>(
      const_cast<T*>(V), wbuf, static_cast<T*>(wnorm_), part, j, active,
      static_cast<const T*>(z_), static_cast<T*>(Z_), m, n, parts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The Arnoldi step's Gram-Schmidt of w (n) against rows 0..*j of V
// (m + 1, n), see above: h1, h2 (m + 1), *wnorm, and while *active
// V[min(*j + 1, m)] and, given Z (m, n), Z[min(*j, m - 1)] = z.  `part`
// holds (m + 1) * ceil(n / 256) doubles, `wbuf` n values.  Returns the
// launches' cudaError_t, or -1 for m < 1 or n < 1.
int nst_gram_schmidt_f32(const void* V, const void* w, void* h1, void* h2,
                         void* wnorm, const int* j, const bool* active,
                         const void* z, void* Z, double* part, void* wbuf,
                         int m, long long n, void* stream) {
  return run<float>(V, w, h1, h2, wnorm, j, active, z, Z, part, wbuf, m, n,
                    stream);
}

int nst_gram_schmidt_f64(const void* V, const void* w, void* h1, void* h2,
                         void* wnorm, const int* j, const bool* active,
                         const void* z, void* Z, double* part, void* wbuf,
                         int m, long long n, void* stream) {
  return run<double>(V, w, h1, h2, wnorm, j, active, z, Z, part, wbuf, m, n,
                     stream);
}

}  // extern "C"
