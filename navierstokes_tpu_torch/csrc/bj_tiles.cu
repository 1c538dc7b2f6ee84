// Block-Jacobi tile rebuild for Hopper (sm_90a): the masked tile
// diagonals of F, the Newton-Schulz guard's norm, and the Newton-Schulz
// update.
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
// stack): about 33 passes a rebuild.  Here the tiles are written once, the
// guard reads A X0 once, and each update reads X and X (A X) once and
// writes once, the last update straight into the caller's buffer (the
// captured step's tile inverses) in the tiles' dtype.  The products A X0,
// X (A X) and A X stay cuBLAS GEMMs in fp32 outside these kernels (the JAX
// package's jnp.matmul).
//
// Bound: device-memory traffic.  Each kernel does a few operations per
// value moved (tiles: 6, guard: 3, update: 2), far below the card's ridge.
//
// Bits: every operation is rounded alone (the _rn intrinsics, which nvcc
// does not contract into fused multiply-adds), in PyTorch's order, so each
// kernel gives its plain version's bits (kernels/bj_tiles.py):
//   tiles   t_ij = ((f_ij * m_i) * m_j) + ((sigma * (1 - m_i)) * e_ij),
//           e_ij = 1 on the diagonal, 0 off it, in f's dtype (fp32 or
//           fp64), then rounded to fp32; f_ij is 0 where the pattern has no
//           value.  Multiplied, never selected: a masked -0 comes out +0 and
//           a masked NaN stays NaN, as in the plain chain.
//   guard   s_i = the sum over j of |e_ij - ax_ij| in fp32 as a pairwise
//           tree over the columns in order (adjacent pairs, then adjacent
//           pairs of those, ...), and the max of s_i over every row of every
//           tile, NaN propagated (a NaN norm fails the guard's test, so the
//           step takes the exact inverse).  The max is order-free, so the
//           grid does not move the bits; no atomics.
//   update  x' = (2 * x) - p in fp32, written in x's layout (the stride
//           order PyTorch's elementwise op gives: the seed, an exact inverse
//           from cuSOLVER, is column-major, the GEMMs' products row-major),
//           or, for the last update, row-major in the output dtype: fp32,
//           bf16 (round to nearest even) or fp64.
//
// Design:
//   tiles   one CTA of 256 threads per band of R consecutive rows of the
//           tile stack (R * SB values of f's dtype, 32 KB of shared
//           memory): the band is zeroed in shared memory, the plan's on-tile
//           values whose positions fall in the band (the plan's (pos, src)
//           pairs sorted by pos, int32, with an offset per tile row) are
//           scattered into it, and the band is written once with the masks
//           and the diagonal applied, 16 bytes a store.
//   guard   a warp per row: each lane reads SB / 32 consecutive values
//           (16-byte loads), sums them as the tree's lower levels, and five
//           xor-shuffle levels finish the tree (a + b == b + a, so every lane
//           holds the tree's sum); each CTA writes the max of its rows, and a
//           second launch of one CTA takes the max of those into the 0-d
//           norm on the device (no host read).
//   update  one CTA of 256 threads per 64 x 64 block of a tile: an operand
//           whose layout differs from the output's is staged through shared
//           memory (read coalesced in its own layout, read back in the
//           output's), the others are read directly; every access of a warp
//           covers 32 consecutive values.
// SB = 64, 128, 256 or 512 (a power of two; the port's tiles are 256).

#include <cuda_bf16.h>
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

constexpr int kGuardThreads = 256;
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

// E = SB / 32 values of a row per lane
template <int E>
__device__ __forceinline__ void load_row(const float* p, float v[E]) {
  if constexpr (E == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < E; q += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + q);
      v[q] = t.x; v[q + 1] = t.y; v[q + 2] = t.z; v[q + 3] = t.w;
    }
  }
}

template <int E>
__global__ void __launch_bounds__(kGuardThreads)
    bj_guard_rows(const float* __restrict__ ax, float* __restrict__ partial,
                      int n_rows) {
  constexpr int sb = 32 * E;
  const int lane = threadIdx.x & 31;
  const int warps = kGuardThreads / 32;
  float m = -CUDART_INF_F;
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < n_rows;
       r += gridDim.x * warps) {
    const int i = r & (sb - 1);
    float v[E];
    load_row<E>(ax + static_cast<size_t>(r) * sb + lane * E, v);
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const float eye = lane * E + q == i ? 1.0f : 0.0f;
      v[q] = fabsf(__fsub_rn(eye, v[q]));
    }
    // the tree's levels inside the lane: adjacent pairs, in order
#pragma unroll
    for (int w = E; w > 1; w >>= 1) {
#pragma unroll
      for (int q = 0; q < w / 2; ++q) v[q] = __fadd_rn(v[2 * q], v[2 * q + 1]);
    }
    float s = v[0];
    // the levels across lanes: lane l adds lane l ^ off's subtree
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    m = nan_max(m, s);
  }
  cta_max(m, partial);
}

__global__ void __launch_bounds__(kMaxThreads)
    bj_guard_max(const float* __restrict__ partial, int n,
                     float* __restrict__ norm) {
  float m = -CUDART_INF_F;
  for (int k = threadIdx.x; k < n; k += kMaxThreads)
    m = nan_max(m, partial[k]);
  cta_max(m, norm);
}

template <int E>
int guard_launch(const void* ax, void* partial, void* norm, int n_rows,
                 int grid, cudaStream_t stream) {
  bj_guard_rows<E><<<grid, kGuardThreads, 0, stream>>>(
      static_cast<const float*>(ax), static_cast<float*>(partial), n_rows);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bj_guard_max<<<1, kMaxThreads, 0, stream>>>(
      static_cast<const float*>(partial), grid, static_cast<float*>(norm));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// update
// ---------------------------------------------------------------------------

constexpr int kBlock = 64;            // a CTA's block of a tile
constexpr int kTx = 32, kTy = 8;      // 256 threads

template <typename O>
struct Out;
template <>
struct Out<float> {
  __device__ static float cvt(float v) { return v; }
};
template <>
struct Out<double> {
  __device__ static double cvt(float v) { return static_cast<double>(v); }
};
template <>
struct Out<__nv_bfloat16> {
  __device__ static __nv_bfloat16 cvt(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Element (i, j) of tile t in a stack of layout COL (false: row-major
// tiles, true: each tile stored transposed).
template <bool COL>
__device__ __forceinline__ size_t at(size_t tb, int i, int j, int sb) {
  return COL ? tb + static_cast<size_t>(j) * sb + i
             : tb + static_cast<size_t>(i) * sb + j;
}

// The block's values of an operand of layout COL into s[i - i0][j - j0],
// each warp access 32 consecutive values of the operand.
template <bool COL>
__device__ __forceinline__ void stage(const float* __restrict__ a, size_t tb,
                                      int i0, int j0, int sb,
                                      float (*s)[kBlock + 1]) {
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
#pragma unroll
  for (int slow = ty; slow < kBlock; slow += kTy) {
#pragma unroll
    for (int fast = tx; fast < kBlock; fast += kTx) {
      const int li = COL ? fast : slow, lj = COL ? slow : fast;
      s[li][lj] = a[at<COL>(tb, i0 + li, j0 + lj, sb)];
    }
  }
}

// out = 2 x - p over one 64 x 64 block; XC, PC, OC: the layouts of x, p and
// the output.
template <typename O, bool XC, bool PC, bool OC>
__global__ void __launch_bounds__(kTx * kTy)
    bj_update_kernel(const float* __restrict__ x, const float* __restrict__ p,
                  O* __restrict__ out, int sb) {
  __shared__ float sx[XC != OC ? kBlock : 1][kBlock + 1];
  __shared__ float sp[PC != OC ? kBlock : 1][kBlock + 1];
  const int nb = sb / kBlock;
  const int b = blockIdx.x % (nb * nb);
  const size_t tb = static_cast<size_t>(blockIdx.x / (nb * nb)) * sb * sb;
  const int i0 = (b / nb) * kBlock, j0 = (b % nb) * kBlock;
  if constexpr (XC != OC) stage<XC>(x, tb, i0, j0, sb, sx);
  if constexpr (PC != OC) stage<PC>(p, tb, i0, j0, sb, sp);
  if constexpr (XC != OC || PC != OC) __syncthreads();
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
#pragma unroll
  for (int slow = ty; slow < kBlock; slow += kTy) {
#pragma unroll
    for (int fast = tx; fast < kBlock; fast += kTx) {
      const int li = OC ? fast : slow, lj = OC ? slow : fast;
      const size_t o = at<OC>(tb, i0 + li, j0 + lj, sb);
      float xv, pv;
      if constexpr (XC != OC) xv = sx[li][lj]; else xv = x[o];
      if constexpr (PC != OC) pv = sp[li][lj]; else pv = p[o];
      out[o] = Out<O>::cvt(__fsub_rn(__fmul_rn(2.0f, xv), pv));
    }
  }
}

template <typename O, bool XC, bool PC, bool OC>
int update_launch3(const void* x, const void* p, void* out, int sb,
                   int n_tiles, cudaStream_t stream) {
  const int nb = sb / kBlock;
  const long long grid = static_cast<long long>(n_tiles) * nb * nb;
  if (grid > 0x7fffffffLL) return -1;
  bj_update_kernel<O, XC, PC, OC><<<static_cast<unsigned>(grid), kTx * kTy, 0,
                                 stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(p),
      static_cast<O*>(out), sb);
  return static_cast<int>(cudaGetLastError());
}

template <typename O, bool OC>
int update_launch(const void* x, const void* p, void* out, int sb,
                  int n_tiles, int x_col, int p_col, cudaStream_t stream) {
  if (x_col) {
    return p_col ? update_launch3<O, true, true, OC>(x, p, out, sb, n_tiles,
                                                     stream)
                 : update_launch3<O, true, false, OC>(x, p, out, sb, n_tiles,
                                                      stream);
  }
  return p_col ? update_launch3<O, false, true, OC>(x, p, out, sb, n_tiles,
                                                    stream)
               : update_launch3<O, false, false, OC>(x, p, out, sb, n_tiles,
                                                     stream);
}

bool tile_size_ok(int sb) {
  return sb == 64 || sb == 128 || sb == 256 || sb == 512;
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

// The guard's norm: ax fp32 (n_tiles, sb, sb) row-major, 16-byte aligned;
// partial fp32 scratch of ``grid`` values; norm a 0-d fp32 tensor.  Two
// launches: the rows' sums and each CTA's max, then the max of those.
int nst_bj_guard(const void* ax, void* partial, void* norm, int sb,
                 int n_tiles, int grid, void* stream) {
  if (!tile_size_ok(sb) || grid < 1) return -1;
  const int n_rows = n_tiles * sb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sb) {
    case 64: return guard_launch<2>(ax, partial, norm, n_rows, grid, s);
    case 128: return guard_launch<4>(ax, partial, norm, n_rows, grid, s);
    case 256: return guard_launch<8>(ax, partial, norm, n_rows, grid, s);
    default: return guard_launch<16>(ax, partial, norm, n_rows, grid, s);
  }
}

// One Newton-Schulz update out = 2 x - p: x, p fp32 (n_tiles, sb, sb),
// each row-major (0) or column-major (1) per tile; out in x's layout in
// fp32 (out_kind 0), or row-major in fp32 (1), bf16 (2) or fp64 (3).
int nst_bj_update(const void* x, const void* p, void* out, int sb,
                  int n_tiles, int x_col, int p_col, int out_kind,
                  void* stream) {
  if (!tile_size_ok(sb)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0:
      return x_col ? update_launch<float, true>(x, p, out, sb, n_tiles, 1,
                                                p_col, s)
                   : update_launch<float, false>(x, p, out, sb, n_tiles, 0,
                                                 p_col, s);
    case 1:
      return update_launch<float, false>(x, p, out, sb, n_tiles, x_col, p_col,
                                         s);
    case 2:
      return update_launch<__nv_bfloat16, false>(x, p, out, sb, n_tiles,
                                                 x_col, p_col, s);
    case 3:
      return update_launch<double, false>(x, p, out, sb, n_tiles, x_col,
                                          p_col, s);
    default:
      return -1;
  }
}

}  // extern "C"
