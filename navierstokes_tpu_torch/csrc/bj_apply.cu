// Block-Jacobi tile apply for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels scripts/exp_fused.py `bj_kern` (fp32
// tiles, `make_bj`) and `bj_kern16` (bf16 tiles, `make_bj16`), and their
// planar twins in scripts/exp_fused2.py, which compute what the JAX
// package's navierstokes_tpu/ops/p1ell.py `block_jacobi_apply` leaves to
// XLA: the inner F solve's preconditioner, applied at every inner
// iteration of the step (ops/p1ell.py, kernels/bj_apply.py).  The fp64
// variant replaces no Pallas kernel (float64 runs on the card).
//
//   y[t * SB + i, c] = sum over k < SB of T[t, i, k] * r[t * SB + k, c]
//
// for every tile t, row i < SB and component c < D (D = 2 or 3), with r
// and y of shape (n_p2, D), row-major.  Rows at or beyond n_p2 read r as 0
// and are neither read from the tiles nor written, so r is taken as it is,
// with no padded copy.
//
// Bound: device-memory traffic.  Each tile value is read once and used for
// D multiply-adds (2 * D flops per 4 bytes in fp32, per 8 in fp64), far
// below the card's ridge, so tensor cores and wgmma bring nothing; both
// designs below stream the tiles once at the HBM rate.  At the bench point
// the tiles are 1,760 x 256 x 256 (461 MB in fp32, 923 MB in fp64), many
// times the 50 MB L2, so no call finds another's lines there.
//
// Both designs sum each row the same way, so they give the same bits:
// * a lane takes columns p * 128 + 4 * lane + j (p < SB / 128, j < 4) of
//   the row and of r's block;
// * a warp sums R = kGroupsPerRound / NP consecutive rows together, the
//   first at a multiple of R of the tile: each lane's fused multiply-adds
//   over its groups in column order from zero, then five levels of
//   shuffles over the warp's lanes (WarpSum: halving exchanges, then a
//   butterfly), whose order depends only on the row's place in its group;
//   the lanes whose butterfly bits are 0 write it, rounded by Tile::out.
// So a row's result depends on its tile values and r alone: not on the
// grid, the SM count, the batch or the tile's place in it.  Row shards
// (parallel/sharded_bsr.py) equal one device bit for bit, the tail tile
// alone equals the batch's rows, and repeats are bit-identical.  No atomics.
//   fp32 tiles sum in double: each fp32 product is exact there, so the
//   row's sum, rounded once to fp32, is the correctly rounded result
//   whatever the order, unless the row's terms cancel by a factor of
//   about a million or more.  The 2 * D flops per 4 bytes stay far below
//   the fp64 rate (34 TFLOP/s), so this costs no time against the memory
//   bound.
//
// Three tile types:
//   fp32  tiles, r and y in fp32, sums in double (bj_kern);
//   bf16  tiles read as bf16, r rounded to bf16, each product exact in
//         fp32 and summed in fp32, the row's sum rounded to bf16, y in fp32
//         (the JAX package's bf16 apply, navierstokes_tpu/ops/p1ell.py:
//         510-516, a bf16 matmul cast back to r's dtype; bj_kern16's
//         preferred_element_type=f32 output skips that last rounding);
//   fp64  tiles, r, sums and y in double.
// SB = 128, 256 or 512 (NP = SB / 128 groups per row); 256 is the port's
// default tile of 256 nodes.
//
// fp64: a bulk-copy ring on a persistent grid (ring_kernel).
// * The work items are blocks of kRows consecutive rows of the tile batch
//   (kRows = 8 R divides SB, so an item lies in one tile): ceil(n_p2 /
//   kRows) of them.  The grid is the card's resident CTAs (one per SM: the
//   ring takes most of its shared memory), at most one per item; CTA b
//   walks the contiguous range [b * per_cta + min(b, n_long), + per_cta +
//   (b < n_long)) in order, a split the wrapper computes
//   (kernels/bj_apply.partition).  No work queue, no tail of short CTAs:
//   the CTAs' shares differ by at most one item.
// * Warp 8 is the producer: its lane 0 copies each item's live rows (one
//   contiguous piece of 32 KB) into the next of 6 stages of a 192 KB ring
//   with one cp.async.bulk, marked evict-first in L2 (as the register
//   stream's __ldcs loads are), completing on the stage's `full` mbarrier.
//   Up to 192 KB per SM are in flight, against the ~25 KB that cover HBM
//   latency at 3.35 TB/s, with no registers or address arithmetic spent on
//   the copies.
// * Warps 0-7 consume (Consumer): warp w reads rows w * R .. w * R + R - 1
//   of the item from its stage, gives the stage back on `empty` (8
//   arrivals), then sums them and writes them.  A proxy fence precedes
//   each give-back: the next bulk copy writes the stage through the async
//   proxy, which the barrier's release does not order after the warp's
//   reads, and without it a copy that hits L2 overwrote rows some lanes
//   had not read (seen on the card at the bench tiles).
// * r once per tile: when the producer enters a tile (an item at the
//   tile's start, or the CTA's first item) it copies the tile's SB x D
//   block of r into a slot of a small ring of its own (one bulk copy of the
//   16-byte-whole part of the live rows; its lanes write the last values
//   and zeros for the rows at or beyond n_p2), and each consumer warp
//   keeps its lanes' values of it in registers until the next tile.
// * The tiles and r must be 16-byte aligned (the bulk copies'); the
//   wrapper checks.  Before the first launch of an instantiation on a
//   device, nst_bj_apply_f64_setup raises its dynamic shared memory limit
//   there and reports its residency and ring.  The evict-first hint is
//   worth 4%: on an H100 (700 W) the ring took 0.3107 ms at the bench tiles
//   without it against 0.2989 with it (tools/bj_apply_ab.py).  The
//   gain holds while the L2 holds other data; right after another kernel
//   has read the same tiles at normal priority the ring runs at the
//   unhinted time (0.3129 ms; the tool's L2 states).  No kernel of the main
//   path reads the tiles but this one.
//
// fp32, bf16: a register stream (stream_kernel), one CTA of 8 warps per
// 64-row slab of a tile: the CTA stages the tile's block of r in shared
// memory, and each warp loads R rows at a time straight into registers
// (16-byte __ldcs loads in fp32, 8-byte in bf16; about 32 KB per CTA in
// flight, several CTAs per SM).  The ring is slower on their d = 2 tiles:
// on an H100 (700 W), built for them with the stream's bits
// (tools/bj_apply_ab.py), it took 0.1524 ms at the bench tiles in
// fp32 against the stream's 0.1469, 0.0824 against 0.0752 in bf16 and
// 0.0289 against 0.0267 at NACA's; faster only at 3D-1Z's d = 3 tiles
// (0.3756 against 0.4201 in fp32, 0.1998 against 0.2123 in bf16), where no
// main path applies tiles.  A later change that routes d = 3 to the ring
// measures it again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 4;                             // values per lane read
constexpr int kRowChunk = 32 * kGroup;               // 128 columns per pass
constexpr int kWarps = 8;                             // warps that sum rows

template <typename V>
struct Tile;

// kGroupsPerRound: a lane's groups of four values per warp round; it fixes
// R, the rows summed together, and so the shuffle order of their sums.
// load: a lane's four values of a row, for fp32 and bf16 from device memory
// marked streaming (evict first), for fp64 from the ring in shared memory.
template <>
struct Tile<float> {
  using Acc = float;
  using Sum = double;
  static constexpr int kGroupsPerRound = 8;
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
  static constexpr int kGroupsPerRound = 4;
  __device__ static void load(const double* p, double a[kGroup]) {
    const double2 t0 = reinterpret_cast<const double2*>(p)[0];
    const double2 t1 = reinterpret_cast<const double2*>(p)[1];
    a[0] = t0.x; a[1] = t0.y; a[2] = t1.x; a[3] = t1.y;
  }
  __device__ static double r_in(double r) { return r; }
  __device__ static double out(double s) { return s; }
};

template <>
struct Tile<__nv_bfloat16> {
  using Acc = float;
  using Sum = float;
  static constexpr int kGroupsPerRound = 8;
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

template <typename V, int NP>
__host__ __device__ constexpr int rows_per_round() {
  return Tile<V>::kGroupsPerRound / NP > 0 ? Tile<V>::kGroupsPerRound / NP
                                           : 1;
}

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
// both hold the same bits).  The d components of R rows take 9 (d=2,
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

// fp32, bf16: the register stream, one CTA per 64-row slab of a tile
constexpr int kStreamThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;   // 64

template <typename V, int NP, int D>
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const V* __restrict__ tiles,
              const typename Tile<V>::Acc* __restrict__ r,
              typename Tile<V>::Acc* __restrict__ y, int n_p2) {
  using A = Tile<V>;
  using T = typename A::Acc;
  using S = typename A::Sum;
  constexpr int SB = NP * kRowChunk;
  constexpr int kSlabs = SB / kRowsPerCta;
  // rows loaded at once per warp
  constexpr int R = rows_per_round<V, NP>();
  static_assert(kRowsPerWarp % R == 0, "rows per warp");
  __shared__ __align__(16) T rs[D * SB];

  const int t = blockIdx.x / kSlabs;
  const int slab = blockIdx.x % kSlabs;
  const long long row0 = static_cast<long long>(t) * SB;   // first node
  // stage r's block of the tile, component-major, zero past n_p2
  for (int idx = threadIdx.x; idx < SB * D; idx += kStreamThreads) {
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
int stream_d(const V* tiles, const void* r, void* y, int n_tiles, int n_p2,
             int D, cudaStream_t st) {
  using T = typename Tile<V>::Acc;
  const int blocks = n_tiles * (NP * kRowChunk / kRowsPerCta);
  const T* rr = static_cast<const T*>(r);
  T* yy = static_cast<T*>(y);
  if (D == 2) {
    stream_kernel<V, NP, 2><<<blocks, kStreamThreads, 0, st>>>(tiles, rr, yy,
                                                              n_p2);
  } else if (D == 3) {
    stream_kernel<V, NP, 3><<<blocks, kStreamThreads, 0, st>>>(tiles, rr, yy,
                                                              n_p2);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int stream_apply(const void* tiles, const void* r, void* y, int n_tiles,
                 int sb, int n_p2, int D, void* stream) {
  if (D != 2 && D != 3) return -1;
  if (sb != 128 && sb != 256 && sb != 512) return -1;
  if (n_tiles <= 0 || n_p2 <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const V* tt = static_cast<const V*>(tiles);
  switch (sb) {
    case 128: return stream_d<V, 1>(tt, r, y, n_tiles, n_p2, D, st);
    case 256: return stream_d<V, 2>(tt, r, y, n_tiles, n_p2, D, st);
    default: return stream_d<V, 4>(tt, r, y, n_tiles, n_p2, D, st);
  }
}

// fp64: the bulk-copy ring on a persistent grid
constexpr int kRingThreads = 32 * (kWarps + 1);     // + the producer warp
constexpr int kRingBytes = 192 * 1024;

// The ring of an instantiation: items of kRows rows, kStages stages of
// kStageBytes, kRSlots slots of r's block (enough for the tiles the
// producer can enter while it runs kStages items ahead of the consumers);
// the shared memory holds the stages, the r slots, then the barriers.
template <typename V, int NP, int D>
struct Ring {
  using T = typename Tile<V>::Acc;
  static constexpr int SB = NP * kRowChunk;
  static constexpr int R = rows_per_round<V, NP>();
  static constexpr int kRows = kWarps * R;
  static constexpr int kStageBytes = kRows * SB * int(sizeof(V));
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kItemsPerTile = SB / kRows;
  static constexpr int kRSlots =
      (kStages + kItemsPerTile - 1) / kItemsPerTile + 1 < kStages
          ? (kStages + kItemsPerTile - 1) / kItemsPerTile + 1
          : kStages;
  static constexpr int kRBytes = SB * D * int(sizeof(T));
  static constexpr int kBarOffset = kStages * kStageBytes + kRSlots * kRBytes;
  static constexpr int kSmem = kBarOffset + 8 * 2 * (kStages + kRSlots);
  static_assert(SB % kRows == 0, "an item lies in one tile");
  static_assert(kStageBytes % 16 == 0 && kRBytes % 16 == 0, "bulk copies");
  static_assert(kSmem <= 232448, "shared memory of one CTA");
  static_assert(sizeof(V) == 8, "fp64 tiles (Tile<double>::load reads the "
                "ring; fp32 and bf16 take the register stream)");
};

// mbarriers and bulk copies (PTX)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// returns once the barrier's phase of parity ``parity`` has completed; a
// phase that never completes is a fault of the kernel, so after 2^28 polls
// (seconds, where a phase takes microseconds) it traps and the launch fails
// rather than hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ uint64_t l2_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// ``bytes`` (a multiple of 16) from global ``src`` to shared ``dst``, both
// 16-byte aligned, completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// Before a consumer warp gives a buffer back to the producer, its lanes'
// shared-memory reads of it must have landed: the next bulk copy writes the
// buffer through the async proxy, which the barrier's release does not order
// after generic reads (the arrive issues right behind the loads otherwise,
// and a copy that hits L2 can overwrite rows some lanes have not read yet).
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
  if (lane == 0) bar_arrive(bar);
}

// A consumer warp's view of the ring: it takes the items of its CTA in
// order; of each it reads its R rows from the stage into registers, gives
// the stage back, then sums them and writes them (``item``).
template <typename V, int NP, int D>
struct Consumer {
  using A = Tile<V>;
  using T = typename A::Acc;
  using S = typename A::Sum;
  using G = Ring<V, NP, D>;
  static constexpr int SB = G::SB;
  static constexpr int R = G::R;

  const V* stages;
  const T* rslots;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* r_full;
  uint64_t* r_empty;
  T* y;
  int n_p2, warp, lane;
  long long begin;
  int stage = 0, slot = 0;
  uint32_t phase = 0, r_phase = 0;
  // this lane's values of r's block, columns p * 128 + lane * 4 + j, for
  // the tile it is in
  T xr[NP][D][kGroup];

  __device__ __forceinline__ void item(long long w) {
    const long long row = w * G::kRows;
    const long long g0 = row + warp * R;            // the group's first row
    // the warp's rows (zeros for rows at or beyond n_p2)
    T a[R][NP][kGroup];
    bar_wait(&full[stage], phase);
    const V* buf = stages + stage * (G::kRows * SB) + warp * R * SB +
                   lane * kGroup;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const bool live = g0 + q < n_p2;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (live) {
          A::load(buf + q * SB + p * kRowChunk, a[q][p]);
        } else {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) a[q][p][j] = T(0);
        }
      }
    }
    release(&empty[stage], lane);
    if (++stage == G::kStages) stage = 0, phase ^= 1;

    if (w == begin || row % SB == 0) {              // a new tile: its r
      bar_wait(&r_full[slot], r_phase);
      const T* rs = rslots + slot * (SB * D);
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int c = 0; c < D; ++c)
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            xr[p][c][j] =
                A::r_in(rs[(p * kRowChunk + lane * kGroup + j) * D + c]);
      release(&r_empty[slot], lane);
      if (++slot == G::kRSlots) slot = 0, r_phase ^= 1;
    }
    if (g0 >= n_p2) return;                         // warp-uniform
    // v[q * D + c]: this lane's partial sum of component c of row q
    S v[R * D];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        S acc = S(0);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            acc = fma_(S(a[q][p][j]), S(xr[p][c][j]), acc);
        v[q * D + c] = acc;
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
        if (g0 + q < n_p2) y[(g0 + q) * D + c] = A::out(v[k]);
      }
    }
  }
};

template <typename V, int NP, int D>
__global__ void __launch_bounds__(kRingThreads, 1)
ring_kernel(const V* __restrict__ tiles,
            const typename Tile<V>::Acc* __restrict__ r,
            typename Tile<V>::Acc* __restrict__ y, int n_p2, int per_cta,
            int n_long) {
  using T = typename Tile<V>::Acc;
  using G = Ring<V, NP, D>;
  constexpr int SB = G::SB;
  constexpr int kRows = G::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  V* stages = reinterpret_cast<V*>(smem);
  T* rslots = reinterpret_cast<T*>(smem + G::kStages * G::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBarOffset);
  uint64_t* empty = full + G::kStages;
  uint64_t* r_full = empty + G::kStages;
  uint64_t* r_empty = r_full + G::kRSlots;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kWarps);
    }
    for (int s = 0; s < G::kRSlots; ++s) {
      bar_init(&r_full[s], 1);
      bar_init(&r_empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int b = blockIdx.x;
  const long long begin =
      static_cast<long long>(b) * per_cta + (b < n_long ? b : n_long);
  const long long end = begin + per_cta + (b < n_long ? 1 : 0);

  if (warp == kWarps) {
    // the producer: each item of the range into the next stage, r's block
    // of each tile it enters into the next r slot
    const uint64_t policy = l2_policy();
    int stage = 0, slot = 0;
    uint32_t phase = 0, r_phase = 0;
    for (long long w = begin; w < end; ++w) {
      const long long row = w * kRows;
      if (w == begin || row % SB == 0) {
        bar_wait(&r_empty[slot], r_phase ^ 1);
        const long long row0 = row - row % SB;
        const int vals = min(SB, static_cast<int>(n_p2 - row0)) * D;
        const int bulk = vals * int(sizeof(T)) / 16 * 16 / int(sizeof(T));
        T* dst = rslots + slot * (SB * D);
        const T* src = r + row0 * D;
        for (int k = bulk + lane; k < SB * D; k += 32)
          dst[k] = k < vals ? src[k] : T(0);
        __syncwarp();
        if (lane == 0) {
          bar_expect(&r_full[slot], bulk * sizeof(T));
          if (bulk > 0)
            bulk_copy(dst, src, bulk * sizeof(T), &r_full[slot], policy);
        }
        if (++slot == G::kRSlots) slot = 0, r_phase ^= 1;
      }
      bar_wait(&empty[stage], phase ^ 1);
      if (lane == 0) {
        const int rows = min(kRows, static_cast<int>(n_p2 - row));
        const uint32_t bytes = rows * SB * sizeof(V);
        bar_expect(&full[stage], bytes);
        bulk_copy(stages + stage * (kRows * SB), tiles + row * SB, bytes,
                  &full[stage], policy);
      }
      if (++stage == G::kStages) stage = 0, phase ^= 1;
    }
    return;
  }

  Consumer<V, NP, D> c{stages, rslots, full, empty, r_full, r_empty, y,
                       n_p2, warp, lane, begin};
  for (long long w = begin; w < end; ++w) c.item(w);
}

template <typename V, int NP, int D>
int ring_setup(int* info) {
  using G = Ring<V, NP, D>;
  const auto kernel = ring_kernel<V, NP, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kRingThreads, G::kSmem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return -2;
  info[0] = per_sm;
  info[1] = sms;
  info[2] = G::kRows;
  info[3] = G::kStages;
  info[4] = G::kStageBytes;
  info[5] = G::kSmem;
  info[6] = G::kRSlots;
  return 0;
}

template <typename V, int NP, int D>
int ring_launch(const void* tiles, const void* r, void* y, int n_p2, int grid,
                int per_cta, int n_long, cudaStream_t st) {
  using T = typename Tile<V>::Acc;
  ring_kernel<V, NP, D><<<grid, kRingThreads, Ring<V, NP, D>::kSmem, st>>>(
      static_cast<const V*>(tiles), static_cast<const T*>(r),
      static_cast<T*>(y), n_p2, per_cta, n_long);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, int NP, int D>
struct Setup {
  static int run(int* info) { return ring_setup<V, NP, D>(info); }
};

template <typename V, int NP, int D>
struct Launch {
  static int run(const void* tiles, const void* r, void* y, int n_p2,
                 int grid, int per_cta, int n_long, cudaStream_t st) {
    return ring_launch<V, NP, D>(tiles, r, y, n_p2, grid, per_cta, n_long,
                                 st);
  }
};

// F<V, NP, D>::run(args...) for the (SB, D) instantiation of the ring; -1
// for an SB or D without one
template <template <typename, int, int> class F, typename V,
          typename... Args>
int ring(int sb, int D, Args... args) {
  if (D != 2 && D != 3) return -1;
  switch (sb) {
    case 128:
      return D == 2 ? F<V, 1, 2>::run(args...) : F<V, 1, 3>::run(args...);
    case 256:
      return D == 2 ? F<V, 2, 2>::run(args...) : F<V, 2, 3>::run(args...);
    case 512:
      return D == 2 ? F<V, 4, 2>::run(args...) : F<V, 4, 3>::run(args...);
    default:
      return -1;
  }
}

template <typename V>
int ring_apply(const void* tiles, const void* r, void* y, int sb, int n_p2,
               int D, int grid, int per_cta, int n_long, void* stream) {
  if (n_p2 <= 0) return 0;
  return ring<Launch, V>(sb, D, tiles, r, y, n_p2, grid, per_cta, n_long,
                         static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// fp32 and bf16 tiles: the register stream.  Launches the (SB, D)
// instantiation on ``stream``; returns cudaGetLastError() after the launch,
// or -1 for an SB or D without an instantiation.  Does not synchronise.
int nst_bj_apply_f32(const void* tiles, const void* r, void* y, int n_tiles,
                     int sb, int n_p2, int D, void* stream) {
  return stream_apply<float>(tiles, r, y, n_tiles, sb, n_p2, D, stream);
}

// tiles: bf16 (raw 16-bit storage); r, y: fp32
int nst_bj_apply_bf16(const void* tiles, const void* r, void* y, int n_tiles,
                      int sb, int n_p2, int D, void* stream) {
  return stream_apply<__nv_bfloat16>(tiles, r, y, n_tiles, sb, n_p2, D,
                                     stream);
}

// fp64 tiles: the ring.  Raises the dynamic shared memory limit of the
// (SB, D) instantiation on the current device and fills ``info`` with its
// CTAs per SM, the device's SMs, rows per item, stages, bytes per stage,
// shared memory bytes per CTA and r slots.  Returns 0, a cudaError_t, -1
// (no instantiation) or -2 (the kernel does not fit on an SM).
int nst_bj_apply_f64_setup(int sb, int D, int* info) {
  return ring<Setup, double>(sb, D, info);
}

// Launches the ring over ``grid`` CTAs, CTA b taking per_cta + (b <
// n_long) items, on ``stream``; returns cudaGetLastError() after the
// launch, or -1 for an SB or D without an instantiation.  Does not
// synchronise.
int nst_bj_apply_f64(const void* tiles, const void* r, void* y, int sb,
                     int n_p2, int D, int grid, int per_cta, int n_long,
                     void* stream) {
  return ring_apply<double>(tiles, r, y, sb, n_p2, D, grid, per_cta, n_long,
                            stream);
}

}  // extern "C"
