// Block-Jacobi tile rebuild for Hopper (sm_90a): the masked tile
// diagonals of F, and the last reduction of the Newton-Schulz guard's norm.
//
// Replaces no Pallas kernel: the JAX package's navierstokes_tpu/ops/p1ell.py
// lays the rebuild out by hand for the TPU and leaves its elementwise work
// to XLA's fusion inside one program:
//   * `block_jacobi_tiles` (:393-456): the tile diagonals of the BC-masked
//     F, t = M F M + sigma (I - M), gathered per step;
//   * `block_jacobi_invert` (:470-507): the guard max row-sum |I - A X0|,
//     and under `lax.cond` the `newton` branch X <- 2X - X (A X).
// The port's stock PyTorch chain ran each of those steps as full passes over
// the tile stack (1,760 tiles of 256 x 256 fp32 at the bench point, 461 MB a
// stack): about 33 passes a rebuild.  Here the tiles are written once.  The
// products A X0, X (A X) and A X are csrc/bj_gemm.cu's GEMM, whose
// epilogues take the guard's row sums (each CTA's max into a partial) and
// the updates; `bj_guard_max` below reduces the partials to the norm.
//
// Bound: device-memory traffic.  The tiles kernel does 6 operations per
// value moved, far below the card's ridge.
//
// Bits: every operation is rounded alone (the _rn intrinsics, which nvcc
// does not contract into fused multiply-adds), in PyTorch's order, so each
// kernel gives its plain version's bits (kernels/bj_tiles.py):
//   tiles   t_ij = ((f_ij * m_i) * m_j) + ((sigma * (1 - m_i)) * e_ij),
//           e_ij = 1 on the diagonal, 0 off it, in f's dtype (fp32 or
//           fp64), then rounded to fp32; f_ij is 0 where the pattern has no
//           value.  Multiplied, never selected: a masked -0 comes out +0 and
//           a masked NaN stays NaN, as in the plain chain.
//   guard   the max of the partials, NaN propagated (a NaN norm fails the
//           guard's test, so the step takes the exact inverse).  The max is
//           order-free, so the grid does not move the bits; no atomics.
//
// Design:
//   tiles   one CTA of 256 threads per band of R consecutive rows of the
//           tile stack (R * SB values of f's dtype, 32 KB of shared
//           memory): the band is zeroed in shared memory, the plan's on-tile
//           values whose positions fall in the band (the plan's (pos, src)
//           pairs sorted by pos, int32, with an offset per tile row) are
//           scattered into it, and the band is written once with the masks
//           and the diagonal applied, 16 bytes a store.
//   guard   one CTA of 1,024 threads: each thread's max over a stride of the
//           partials, then the CTA's max into the 0-d norm on the device (no
//           host read).
// SB = 64, 128, 256 or 512 (a power of two; the port's tiles are 256).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

// arithmetic in the tiles' build dtype, each operation rounded alone
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float to_f32(float a) { return a; }
};

template <>
struct Arith<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static float to_f32(double a) { return __double2float_rn(a); }
};

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

constexpr int kTilesThreads = 256;
constexpr int kBandBytes = 32768;

// Rows [g0, g0 + R) of the stack, R * SB values; sb = 1 << sb_log2.
template <typename T>
__global__ void __launch_bounds__(kTilesThreads)
    bj_tiles_kernel(const T* __restrict__ f, const int* __restrict__ pos,
                 const int* __restrict__ src, const int* __restrict__ row_ptr,
                 const T* __restrict__ mask, const T* __restrict__ sigma,
                 float* __restrict__ out, int sb_log2, int n_rows, int n_p2,
                 int R) {
  extern __shared__ __align__(16) unsigned char tiles_smem[];
  T* band = reinterpret_cast<T*>(tiles_smem);
  const int sb = 1 << sb_log2;
  const int g0 = blockIdx.x * R;
  const int rows = min(R, n_rows - g0);
  const int n = rows << sb_log2;
  for (int e = threadIdx.x; e < n; e += kTilesThreads) band[e] = T(0);
  __syncthreads();
  const int base = g0 << sb_log2;     // the stack holds < 2^31 values
  const int k1 = row_ptr[g0 + rows];
  for (int k = row_ptr[g0] + threadIdx.x; k < k1; k += kTilesThreads)
    band[pos[k] - base] = f[src[k]];
  __syncthreads();
  const T s = *sigma;
  const T one = T(1);
  // four consecutive values of one row per thread and pass (SB % 4 == 0)
  for (int e = 4 * threadIdx.x; e < n; e += 4 * kTilesThreads) {
    const int g = g0 + (e >> sb_log2);       // the row in the stack
    const int i = g & (sb - 1);              // its row in the tile
    const int j0 = e & (sb - 1);             // the first column
    const int col0 = g - i;                  // the tile's first row
    const T mi = g < n_p2 ? mask[g] : T(0);
    const T d = Arith<T>::mul(s, Arith<T>::sub(one, mi));
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      const T mj = col0 + j < n_p2 ? mask[col0 + j] : T(0);
      const T eye = i == j ? one : T(0);
      const T fm = Arith<T>::mul(Arith<T>::mul(band[e + q], mi), mj);
      v[q] = Arith<T>::to_f32(Arith<T>::add(fm, Arith<T>::mul(d, eye)));
    }
    *reinterpret_cast<float4*>(out + base + e) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <typename T>
int tiles_launch(const void* f, const void* pos, const void* src,
                 const void* row_ptr, const void* mask, const void* sigma,
                 void* out, int sb, int n_tiles, int n_p2, void* stream) {
  int sb_log2 = 0;
  while ((1 << sb_log2) < sb) ++sb_log2;
  if ((1 << sb_log2) != sb || sb < 64 || sb > 512) return -1;
  const int R = kBandBytes / (sb * static_cast<int>(sizeof(T)));
  const int n_rows = n_tiles * sb;
  const int grid = (n_rows + R - 1) / R;
  const size_t smem = static_cast<size_t>(R) * sb * sizeof(T);
  bj_tiles_kernel<T><<<grid, kTilesThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f), static_cast<const int*>(pos),
      static_cast<const int*>(src), static_cast<const int*>(row_ptr),
      static_cast<const T*>(mask), static_cast<const T*>(sigma),
      static_cast<float*>(out), sb_log2, n_rows, n_p2, R);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// guard
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 1024;

// max that keeps a NaN from either side
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// The CTA's max into partial[blockIdx.x] (blockDim.x a multiple of 32).
__device__ __forceinline__ void cta_max(float m, float* partial) {
  __shared__ float warp_maxes[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = warp_max(m);
  if (lane == 0) warp_maxes[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < static_cast<int>(blockDim.x >> 5) ? warp_maxes[lane]
                                                 : -CUDART_INF_F;
    m = warp_max(m);
    if (lane == 0) partial[blockIdx.x] = m;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    bj_guard_max(const float* __restrict__ partial, int n,
                     float* __restrict__ norm) {
  float m = -CUDART_INF_F;
  for (int k = threadIdx.x; k < n; k += kMaxThreads)
    m = nan_max(m, partial[k]);
  cta_max(m, norm);
}

}  // namespace

extern "C" {

// The masked tiles: f, mask and sigma (a 0-d device tensor) in fp32
// (suffix f32) or fp64 (f64); pos, src, row_ptr int32; out fp32 (n_tiles,
// sb, sb), row-major, 16-byte aligned.  Returns cudaGetLastError() after
// the launch, or -1 for an SB without an instantiation.  Does not
// synchronise.
int nst_bj_tiles_f32(const void* f, const void* pos, const void* src,
                     const void* row_ptr, const void* mask, const void* sigma,
                     void* out, int sb, int n_tiles, int n_p2, void* stream) {
  return tiles_launch<float>(f, pos, src, row_ptr, mask, sigma, out, sb,
                             n_tiles, n_p2, stream);
}

int nst_bj_tiles_f64(const void* f, const void* pos, const void* src,
                     const void* row_ptr, const void* mask, const void* sigma,
                     void* out, int sb, int n_tiles, int n_p2, void* stream) {
  return tiles_launch<double>(f, pos, src, row_ptr, mask, sigma, out, sb,
                              n_tiles, n_p2, stream);
}

// The guard's norm: the max of the n fp32 partials (one per CTA of
// csrc/bj_gemm.cu's guard epilogue), NaN kept, into the 0-d fp32 norm.
// One launch of one CTA.
int nst_bj_guard_max(const void* partial, int n, void* norm, void* stream) {
  if (n < 1) return -1;
  bj_guard_max<<<1, kMaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), n, static_cast<float*>(norm));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
