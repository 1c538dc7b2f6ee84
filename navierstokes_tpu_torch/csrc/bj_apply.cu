// Block-Jacobi tile apply for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels scripts/exp_fused.py `bj_kern` (fp32
// tiles, `make_bj`) and `bj_kern16` (bf16 tiles, `make_bj16`), and their
// planar twins in scripts/exp_fused2.py, which compute what the JAX
// package's navierstokes_tpu/ops/p1ell.py `block_jacobi_apply` leaves to
// XLA: the inner F solve's preconditioner, applied at every inner
// iteration of the step (ops/p1ell.py, kernels/bj_apply.py):
//
//   y[t * SB + i, c] = sum over k < SB of T[t, i, k] * r[t * SB + k, c]
//
// for every tile t, row i < SB and component c < D (D = 2 or 3), with r
// and y of shape (n_p2, D), row-major.  Rows at or beyond n_p2 read r as 0
// and are neither read from the tiles nor written, so r is taken as it is,
// with no padded copy.
//
// Bound: device-memory traffic.  Each tile value is read once and used for
// D multiply-adds: 2 * D flops per 4 bytes in fp32 (0.5 * D flop/byte),
// against the card's fp32 ridge of about 20 flop/byte, so tensor cores and
// wgmma bring nothing; the design streams the tiles once at the HBM rate.
// At the bench point the tiles are 1,760 x 256 x 256 fp32 (461 MB), nine
// times the 50 MB L2, so no call finds another's lines there.
//
// * One CTA of 8 warps takes a slab of 64 rows of one tile (7,040 CTAs at
//   the bench point), each warp 8 rows.  The CTA first stages the tile's
//   SB x D block of r in shared memory (component-major, zero past n_p2),
//   and each lane keeps the 4 * SB / 128 * D values of r it multiplies in
//   registers for all its rows.
// * A row is read as SB / 128 groups of four consecutive values per lane
//   (a 16-byte load in fp32, 8 bytes in bf16, two 16-byte loads in fp64),
//   marked streaming (__ldcs: evict first).  A warp loads R rows at once
//   (R * SB / 128 = 8 groups in fp32 and bf16, 4 in fp64), about 128 bytes
//   per lane and 32 KB per CTA in flight, well above the ~25 KB per SM that
//   covers HBM latency at 3.35 TB/s.
// * Each row is summed in a fixed order: each lane's fused multiply-adds
//   over its groups in column order from zero, then five levels of
//   shuffles over the warp's lanes (WarpSum: halving exchanges, then a
//   butterfly), whose order depends only on the row's place in its
//   warp's group.
//   fp32 tiles sum in double: each fp32 product is exact there, so the
//   row's sum, rounded once to fp32, is the correctly rounded result
//   whatever the order, unless the row's terms cancel by a factor of
//   about a million or more.  The 2 * D flops per 4 bytes stay far below
//   the fp64 rate (34 TFLOP/s), so this costs no time against the memory
//   bound.
//   No atomics, no dependence on the tile's index or the tile count: a
//   tile's result is the same alone or inside any batch (row shards,
//   parallel/sharded_bsr.py, equal one device bit for bit), and repeated
//   runs are bit-identical.
//
// Three tile types, one template:
//   fp32  tiles, r and y in fp32, sums in double (bj_kern);
//   bf16  tiles read as bf16, r rounded to bf16, each product exact in
//         fp32 and summed in fp32, the row's sum rounded to bf16, y in fp32
//         (the JAX package's bf16 apply, navierstokes_tpu/ops/p1ell.py:
//         510-516, a bf16 matmul cast back to r's dtype; bj_kern16's
//         preferred_element_type=f32 output skips that last rounding);
//   fp64  tiles, r, sums and y in double (float64 runs on the card; no
//         Pallas counterpart).
// SB = 128, 256 or 512 (NP = SB / 128 groups per row); 256 is the port's
// default tile of 256 nodes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;   // 64
constexpr int kGroup = 4;                             // values per load
constexpr int kRowChunk = 32 * kGroup;               // 128 columns per pass

template <typename V>
struct Tile;

template <>
struct Tile<float> {
  using Acc = float;
  using Sum = double;
  static constexpr int kGroupsInFlight = 8;
  __device__ static void load(const float* p, float a[kGroup]) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
  }
  __device__ static float r_in(float r) { return r; }
  __device__ static float out(double s) { return __double2float_rn(s); }
};

template <>
struct Tile<double> {
  using Acc = double;
  using Sum = double;
  static constexpr int kGroupsInFlight = 4;
  __device__ static void load(const double* p, double a[kGroup]) {
    const double2 t0 = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 t1 = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    a[0] = t0.x; a[1] = t0.y; a[2] = t1.x; a[3] = t1.y;
  }
  __device__ static double r_in(double r) { return r; }
  __device__ static double out(double s) { return s; }
};

template <>
struct Tile<__nv_bfloat16> {
  using Acc = float;
  using Sum = float;
  static constexpr int kGroupsInFlight = 8;
  // a bf16 is the high half of the fp32 with the same value
  __device__ static void load(const __nv_bfloat16* p, float a[kGroup]) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
    a[0] = __uint_as_float(t.x << 16);
    a[1] = __uint_as_float(t.x & 0xffff0000u);
    a[2] = __uint_as_float(t.y << 16);
    a[3] = __uint_as_float(t.y & 0xffff0000u);
  }
  // r rounded to bf16 once, when staged; the tile value and r are then
  // both bf16, so their fp32 product is exact and the fused multiply-add
  // rounds only the fp32 sum
  __device__ static float r_in(float r) {
    return __bfloat162float(__float2bfloat16_rn(r));
  }
  __device__ static float out(float s) {
    return __bfloat162float(__float2bfloat16_rn(s));
  }
};

template <typename T>
__device__ __forceinline__ T fma_(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
template <>
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// The warp's sum of M partial sums per lane over its 32 lanes, in a fixed
// order.  While M is even, a level with lane offset OFF halves the values
// each lane holds (a reduce-scatter): lanes with bit OFF set keep the upper
// half, the others the lower half, and each adds its partner's copy of the
// half it keeps, one shuffle per kept value; ``base`` is the index of the
// lane's first value.  Once M is odd, the remaining levels are a butterfly
// over all M values (every lane of the pair adds the same two values, so
// both hold the same bits).  The d components of 8 / R rows take 9 (d=2,
// R=4) or 18 (d=3) shuffles per lane instead of a butterfly's 40 or 60.
__host__ __device__ constexpr int sums_left(int m, int off) {
  return off == 0 ? m
                  : (m % 2 == 0 ? sums_left(m / 2, off / 2)
                                : sums_left(m, off / 2));
}

__host__ __device__ constexpr int butterfly_lanes(int m, int off) {
  return off == 0 ? 0
                  : (m % 2 == 0 ? butterfly_lanes(m / 2, off / 2)
                                : off | butterfly_lanes(m, off / 2));
}

template <int M, int OFF>
struct WarpSum {
  template <typename S>
  __device__ static void run(S* v, int lane, int& base) {
    if constexpr (M % 2 == 0) {
      const bool up = lane & OFF;
#pragma unroll
      for (int k = 0; k < M / 2; ++k) {
        const S send = up ? v[k] : v[k + M / 2];
        const S keep = up ? v[k + M / 2] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      base += up ? M / 2 : 0;
      WarpSum<M / 2, OFF / 2>::run(v, lane, base);
    } else {
#pragma unroll
      for (int k = 0; k < M; ++k)
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], OFF);
      WarpSum<M, OFF / 2>::run(v, lane, base);
    }
  }
};

template <int M>
struct WarpSum<M, 0> {
  template <typename S>
  __device__ static void run(S*, int, int&) {}
};

template <typename V, int NP, int D>
__global__ void __launch_bounds__(kThreads)
bj_apply_kernel(const V* __restrict__ tiles,
                const typename Tile<V>::Acc* __restrict__ r,
                typename Tile<V>::Acc* __restrict__ y, int n_p2) {
  using A = Tile<V>;
  using T = typename A::Acc;
  using S = typename A::Sum;
  constexpr int SB = NP * kRowChunk;
  constexpr int kSlabs = SB / kRowsPerCta;
  // rows loaded at once per warp
  constexpr int R = A::kGroupsInFlight / NP > 0 ? A::kGroupsInFlight / NP : 1;
  static_assert(kRowsPerWarp % R == 0, "rows per warp");
  __shared__ __align__(16) T rs[D * SB];

  const int t = blockIdx.x / kSlabs;
  const int slab = blockIdx.x % kSlabs;
  const long long row0 = static_cast<long long>(t) * SB;   // first node
  // stage r's block of the tile, component-major, zero past n_p2
  for (int idx = threadIdx.x; idx < SB * D; idx += kThreads) {
    const int k = idx / D, c = idx % D;
    const long long g = row0 + k;
    rs[c * SB + k] = g < n_p2 ? A::r_in(r[g * D + c]) : T(0);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this lane's values of r: columns p * 128 + lane * 4 + j
  T xr[NP][D][kGroup];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int c = 0; c < D; ++c)
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        xr[p][c][j] = rs[c * SB + p * kRowChunk + lane * kGroup + j];

  const int i_warp = slab * kRowsPerCta + warp * kRowsPerWarp;
#pragma unroll 1
  for (int i0 = i_warp; i0 < i_warp + kRowsPerWarp; i0 += R) {
    if (row0 + i0 >= n_p2) break;                  // warp-uniform
    T a[R][NP][kGroup];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const V* rowp = tiles + (row0 + i0 + q) * SB + lane * kGroup;
      const bool live = row0 + i0 + q < n_p2;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (live) {
          A::load(rowp + p * kRowChunk, a[q][p]);
        } else {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) a[q][p][j] = T(0);
        }
      }
    }
    // v[q * D + c]: this lane's partial sum of component c of row q
    S v[R * D];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        S s = S(0);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            s = fma_(S(a[q][p][j]), S(xr[p][c][j]), s);
        v[q * D + c] = s;
      }
    int base = 0;
    WarpSum<R * D, 16>::run(v, lane, base);
    // value base + k (row q, component c) is whole in every lane whose
    // butterfly bits are 0; those lanes write it
    constexpr int kLeft = sums_left(R * D, 16);
    constexpr int kButterfly = butterfly_lanes(R * D, 16);
    if ((lane & kButterfly) == 0) {
#pragma unroll
      for (int k = 0; k < kLeft; ++k) {
        const int q = (base + k) / D, c = (base + k) % D;
        if (row0 + i0 + q < n_p2)
          y[(row0 + i0 + q) * D + c] = A::out(v[k]);
      }
    }
  }
}

template <typename V, int NP>
int launch_d(const V* tiles, const void* r, void* y, int n_tiles, int n_p2,
             int D, cudaStream_t st) {
  using T = typename Tile<V>::Acc;
  const int blocks = n_tiles * (NP * kRowChunk / kRowsPerCta);
  const T* rr = static_cast<const T*>(r);
  T* yy = static_cast<T*>(y);
  if (D == 2) {
    bj_apply_kernel<V, NP, 2><<<blocks, kThreads, 0, st>>>(tiles, rr, yy,
                                                          n_p2);
  } else if (D == 3) {
    bj_apply_kernel<V, NP, 3><<<blocks, kThreads, 0, st>>>(tiles, rr, yy,
                                                          n_p2);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the (SB, D) instantiation for tile type V; returns
// cudaGetLastError() after the launch, or -1 for an SB or D without an
// instantiation.  Does not synchronise.
template <typename V>
int dispatch(const void* tiles, const void* r, void* y, int n_tiles, int sb,
             int n_p2, int D, void* stream) {
  if (D != 2 && D != 3) return -1;
  if (sb != 128 && sb != 256 && sb != 512) return -1;
  if (n_tiles <= 0 || n_p2 <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const V* tt = static_cast<const V*>(tiles);
  switch (sb) {
    case 128: return launch_d<V, 1>(tt, r, y, n_tiles, n_p2, D, st);
    case 256: return launch_d<V, 2>(tt, r, y, n_tiles, n_p2, D, st);
    default: return launch_d<V, 4>(tt, r, y, n_tiles, n_p2, D, st);
  }
}

}  // namespace

extern "C" {

int nst_bj_apply_f32(const void* tiles, const void* r, void* y, int n_tiles,
                     int sb, int n_p2, int D, void* stream) {
  return dispatch<float>(tiles, r, y, n_tiles, sb, n_p2, D, stream);
}

// tiles: bf16 (raw 16-bit storage); r, y: fp32
int nst_bj_apply_bf16(const void* tiles, const void* r, void* y, int n_tiles,
                      int sb, int n_p2, int D, void* stream) {
  return dispatch<__nv_bfloat16>(tiles, r, y, n_tiles, sb, n_p2, D, stream);
}

int nst_bj_apply_f64(const void* tiles, const void* r, void* y, int n_tiles,
                     int sb, int n_p2, int D, void* stream) {
  return dispatch<double>(tiles, r, y, n_tiles, sb, n_p2, D, stream);
}

}  // extern "C"
