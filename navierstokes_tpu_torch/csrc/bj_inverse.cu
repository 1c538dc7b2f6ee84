// Block-Jacobi exact tile inverse for Hopper (sm_90a): Gauss-Jordan
// elimination with partial pivoting, one thread-block cluster per tile.
//
// Replaces `jnp.linalg.inv` in navierstokes_tpu/ops/p1ell.py
// `block_jacobi_invert` (:489, no seed; :506, the `lax.cond` fallback when
// the Newton-Schulz guard reaches 0.9), which XLA lowers to a batched LU;
// no Pallas kernel.  The port ran cuSOLVER's batched inverse there, then a
// row-major copy and a copy into the captured step's buffer.
//
// Bound: operations.  A tile of SB x SB takes SB^3 products and SB^3 sums
// or differences (2 SB^3 flops: 59 GFLOP for the bench point's 1,760 tiles
// of 256, 0.88 ms at the card's 67 TFLOP/s fp32); each is its own
// instruction (below), so the instruction floor is twice that, 1.76 ms.
// Bytes: the tiles read once and the inverses written once (0.28 ms).
//
// Bits: the plain version (kernels/bj_inverse.py `gauss_jordan_plain`)
// eliminates column by column, k = 0 .. SB-1, on the whole tile:
//   pivot   the row not yet pivoted with the largest |a_ik|, ties to the
//           lowest row position (LAPACK's isamax), a NaN below any number;
//           it takes position k, the row there takes its old one (rows are
//           not moved: the inverse's row pos[r] is the tile's row r, its
//           column perm[g] the column g);
//   pivot row  r = 1 / d (d = a_pk), u_j = a_pj r, u_k = r (LAPACK's
//           sgetf2 scales by the reciprocal too);
//   others  a_ij <- a_ij - f_i u_j, f_i = a_ik (a_ik <- 0 first);
// in panels of 16 columns: the panel's columns and its 16 pivot rows take
// the steps one at a time, every other value takes the panel's steps at
// once, a_ij - (f_0 u_0 + f_1 u_1 + ... + f_15 u_15), the products summed in
// step order (a blocked LU's trailing update: one subtraction a panel, not
// 16, keeps the residual |I - A X| near cuSOLVER's; one step at a time left
// it 3x cuSOLVER's); every operation rounded alone (the _rn intrinsics,
// which nvcc does not contract into fused multiply-adds).  The kernel gives
// every value the plain version's operations in its order, so it repeats
// its bits; the result is rounded once to fp32, bf16 (round to nearest
// even) or fp64.  Which CTA does an operation, and when, is free.
//
// Design: a 256 x 256 fp32 tile (256 KB) does not fit one CTA's shared
// memory, so a tile is a cluster of C = SB / 64 CTAs, each holding 64
// columns of all SB rows in shared memory (68 floats a row: 16-byte aligned
// rows, a column's reads spread over 8 banks).  Panel P (16 columns) lives
// in CTA P mod C (cyclic: CTA c holds panels c, c + C, c + 2C, c + 3C), so
// consecutive panels have different owners and the next panel's
// factorisation runs beside this panel's trailing update (look-ahead):
//   A   the owner of panel N factors it, a thread per row holding the row's
//       16 panel values in registers, one block barrier per column: before
//       it each row writes itself scaled by its own reciprocal into a copy
//       (the panel's own slab columns and its own multiplier buffer take
//       turns: both are free while the panel lives in registers) and each
//       warp takes its largest (key, position) pair by two redux.sync;
//       after it the warps' pairs give the pivot, whose scaled row is one
//       read; each row updates the next column's value first and starts
//       that column's pivot search before its other 15 updates;
//   -   the panel's buffer (its multipliers F, the pivots and reciprocals,
//       the pivot rows' multipliers and a mask of its pivot rows) goes to
//       every other CTA by one bulk copy each (cp.async.bulk, shared to
//       shared), counted in bytes on their `full` mbarrier;
//   B'  every CTA takes the panel's 16 pivot rows through the panel's 16
//       steps on its own columns, four lanes a column (a lane holds four of
//       the rows; the holder of a step's row shuffles its u to the others):
//       the u_j of each step and the pivot rows' new values;
//   B   every CTA updates its other rows: each thread sums the 16 steps'
//       products of an 8 x 8 block in registers, reading 8 f and 8 u per
//       step (16-byte loads), and subtracts them from the block once.
// Order, per CTA, when panel P has landed: the owner of P + 1 first
// applies P to its own 16 columns of P + 1 (B' there, then B fused into
// A's load), factors P + 1 and sends it, then applies P to its other
// columns; every other CTA applies P to all its columns.  So a panel's
// critical path is the 16-column update, A and the copy; the other 48 or
// 64 columns' update runs under the next panel's.  Buffers: two (P mod 2);
// a CTA that has read panel P's arrives on the owner of P + 2's `empty`
// mbarrier, which that owner waits on before its copies (waits by phase
// parity).  Two buffers in 109 KB keep two CTAs an SM.
// The inverse's rows and columns are written in their final places, in the
// output dtype, at the caller's tile and row strides (row-major tiles).
// A cluster never reads another tile, so a tile's inverse does not depend
// on the batch it sits in.  SB = 64, 128, 256 or 512 (clusters of 1, 2, 4
// or 8 CTAs; at 256 the card holds 62 clusters at once).
// Measured (PERF.md section 6, H100 at 700 W): 5.7-6.1 ms at 1,760 tiles
// of 256 (the earlier schedule, blocked ownership and one cluster barrier
// a panel: 6.8-7.4), 6.4-6.9x the bound.  What holds it (tools/
// bj_inverse_profile.py, clocks by phase): A, about 950 clocks a column on
// the owner, which shares its SM with another tile's CTA and its warp
// schedulers with that CTA's trailing update; then the look-ahead's
// 16-column update, 4,300-5,500 clocks a panel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kW = 64;        // columns a CTA holds
constexpr int kNb = 16;       // the panel's columns
constexpr int kLd = kW + 4;   // a row's floats in shared memory
constexpr int kMaxWarps = 16;

template <int SB>
struct Cfg {
  static constexpr int kCtas = SB / kW;
  static constexpr int kThreads = SB;   // a row each (A), an 8x8 block (B)
  static constexpr int kWarps = SB / 32;
  static constexpr int kPanels = SB / kNb;
  // a panel's buffer: its multipliers F (F[m * SB + row]), then its
  // header: (pivot row, position, reciprocal, 0) per step, the pivot rows'
  // multipliers fp[m][s] = F[m][pivot row of step s], and the panel's
  // pivot rows as a mask (a word a warp of rows); the whole buffer goes
  // to the other CTAs
  static constexpr int kFBytes = kNb * SB * 4;
  static constexpr int kHdrFp = kNb * 16;
  static constexpr int kHdrMask = kHdrFp + kNb * kNb * 4;
  static constexpr int kMask = kWarps * 4 < 16 ? 16 : (kWarps * 4 + 15) / 16 * 16;
  static constexpr int kBuf = kFBytes + kHdrMask + kMask;
  // shared memory, in bytes from the start
  static constexpr size_t kSlab = 0;                                 // SB x kLd f32
  static constexpr size_t kB = kSlab + size_t(SB) * kLd * 4;         // 2 buffers
  static constexpr size_t kU = kB + size_t(2) * kBuf;                // kNb x kW f32
  static constexpr size_t kRed = kU + size_t(kNb) * kW * 4;          // 2 x kMaxWarps x 2 u32
  static constexpr size_t kBar = kRed + 2 * kMaxWarps * 2 * 4;       // 4 mbarriers
  static constexpr size_t kBytes = kBar + 4 * 8;
  static_assert(SB % kW == 0 && kCtas <= 8, "SB = 64 .. 512");
  static_assert(kWarps <= kMaxWarps, "at most 16 warps");
  static_assert(kB % 16 == 0 && kBuf % 16 == 0 && kU % 16 == 0 &&
                kBar % 8 == 0, "aligned");
  static_assert(kBytes <= 232448, "one CTA's shared memory");
  static_assert(SB != 256 || 2 * (kBytes + 1024) <= 233472,
                "two CTAs an SM at SB = 256");
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// the shared-memory address `local` of this CTA in CTA `rank`
__device__ __forceinline__ unsigned remote(unsigned local, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}
// this CTA's arrival on its own barrier, expecting `tx` bytes
__device__ __forceinline__ void mbar_arm(unsigned bar, unsigned tx) {
  if (tx)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(tx) : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}
// an arrival on another CTA's barrier, ordering this CTA's reads before it
__device__ __forceinline__ void mbar_arrive_remote(unsigned rbar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               :: "r"(rbar) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n}"
      :: "r"(bar), "r"(parity) : "memory");
}
// this thread's shared-memory writes, ordered before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// a copy of `bytes` (a multiple of 16) from this CTA's shared memory into
// another CTA's, counted in bytes on its barrier
__device__ __forceinline__ void bulk_copy(unsigned dst, unsigned src,
                                          unsigned bytes, unsigned rbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(rbar) : "memory");
}

template <typename O> __device__ __forceinline__ O cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ double cvt<double>(float v) {
  return static_cast<double>(v);
}

// The pivot search's key of a row at step k: 0 pivoted, 1 NaN, else
// |x|'s bits + 2 (monotonic in |x|).  A row's (key, (0xFFFF - position) <<
// 16 | row) pairs compare as one 64-bit number: the largest key, then the
// lowest position.
__device__ __forceinline__ unsigned pivot_key(float x, int pos, int k) {
  const unsigned ax = __float_as_uint(x) & 0x7FFFFFFFu;
  const unsigned key = ax > 0x7F800000u ? 1u : ax + 2u;   // NaN: 1
  return pos < k ? 0u : key;
}
// the warp's largest (hi, lo) pair, in every lane
__device__ __forceinline__ void warp_max(unsigned& hi, unsigned& lo) {
  const unsigned h = __reduce_max_sync(0xffffffffu, hi);
  lo = __reduce_max_sync(0xffffffffu, hi == h ? lo : 0u);
  hi = h;
}
// 16 floats of a row to and from shared memory, 16 bytes a store; with
// `sw` the four chunks of row `row` swizzled (chunk c4 at c4 ^ (row / 2 % 4)),
// so that a warp's rows of 64 bytes spread over all banks
template <bool sw = false>
__device__ __forceinline__ void put_row(float* dst, const float (&v)[16],
                                        int row = 0) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int c4 = 0; c4 < 4; ++c4)
    d[sw ? c4 ^ ((row >> 1) & 3) : c4] = make_float4(
        v[4 * c4], v[4 * c4 + 1], v[4 * c4 + 2], v[4 * c4 + 3]);
}
template <bool sw = false>
__device__ __forceinline__ void get_row(const float* src, float (&v)[16],
                                        int row = 0) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int c4 = 0; c4 < 4; ++c4) {
    const float4 t = s[sw ? c4 ^ ((row >> 1) & 3) : c4];
    v[4 * c4] = t.x; v[4 * c4 + 1] = t.y;
    v[4 * c4 + 2] = t.z; v[4 * c4 + 3] = t.w;
  }
}

template <int SB, typename O>
__global__ void __launch_bounds__(SB, SB <= 256 ? 2 : 1)
    bj_inverse_kernel(const float* __restrict__ a, O* __restrict__ out,
                      long long out_ts, int out_rs) {
  using C = Cfg<SB>;
  constexpr int kC = C::kCtas;
  extern __shared__ __align__(16) unsigned char smem[];
  float* slab = reinterpret_cast<float*>(smem + C::kSlab);
  float* U = reinterpret_cast<float*>(smem + C::kU);
  unsigned* red = reinterpret_cast<unsigned*>(smem + C::kRed);
  auto buf = [&](int b) { return smem + C::kB + b * C::kBuf; };
  // mbarriers: full[2] (a panel has landed in buffer b), empty[2] (the
  // other CTAs have read buffer b)
  const unsigned bar0 = saddr(smem + C::kBar);
  auto full = [&](int b) { return bar0 + 8u * b; };
  auto empty = [&](int b) { return bar0 + 16u + 8u * b; };

  const unsigned rank = kC > 1 ? cluster_rank() : 0u;
  const size_t tile = blockIdx.x / kC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto owner = [](int P) { return static_cast<unsigned>(P % kC); };
  // the local column of panel P in its owner; the tile's column of a
  // local column of this CTA
  auto lcol = [](int P) { return (P / kC) * kNb; };
  auto gcol = [&](int lc) {
    return ((lc / kNb) * kC + static_cast<int>(rank)) * kNb + lc % kNb;
  };
  auto arm = [&](int P) {       // full[P % 2] for panel P
    mbar_arm(full(P & 1), rank == owner(P) ? 0u : C::kBuf);
  };
  if (kC > 1) {
    if (tid == 0) {
      mbar_init(full(0), 1);
      mbar_init(full(1), 1);
      mbar_init(empty(0), kC - 1);
      mbar_init(empty(1), kC - 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      arm(0);
      arm(1);
    }
    cluster_arrive_relaxed();   // this CTA's barriers exist: others may send
  }

  // this CTA's 64 columns of the tile (panels rank, rank + C, ...)
  const float* at = a + tile * SB * SB;
  for (int e = tid; e < SB * (kW / 4); e += SB) {
    const int r = e / (kW / 4), lc = 4 * (e % (kW / 4));
    *reinterpret_cast<float4*>(slab + r * kLd + lc) =
        *reinterpret_cast<const float4*>(at + static_cast<size_t>(r) * SB +
                                         gcol(lc));
  }
  int mypos = tid;              // the position of row tid
  __syncthreads();
  if (kC > 1) cluster_wait();

  // the other CTAs of the cluster, rank + i (i = 1 is the next panel's
  // owner, which waits first)
  unsigned rbase[kC];
#pragma unroll
  for (int i = 1; i < kC; ++i)
    rbase[i] = remote(saddr(smem), (rank + i) % kC);
  unsigned eph = 0;             // empty[b]'s phase bits
  for (int P = -1; P < C::kPanels; ++P) {
    const int N = P + 1;        // the next panel
    const bool ahead = N < C::kPanels && rank == owner(N);
    const int b = P & 1;
    const float* F = reinterpret_cast<const float*>(buf(b));  // F[m * SB + row]
    const unsigned char* H = buf(b) + C::kFBytes;
    const uint4* pqr = reinterpret_cast<const uint4*>(H);
    const float* Fp = reinterpret_cast<const float*>(H + C::kHdrFp);
    const unsigned* pmask = reinterpret_cast<const unsigned*>(H + C::kHdrMask);
    // the 8-column blocks of this CTA that take panel P's update
    unsigned act = 0xFFu;
    if (P >= 0) {
      // -- phase: waiting for panel P
      if (kC > 1) mbar_wait(full(b), (P >> 1) & 1);
      // -- phase: panel P's pivots read back
      if (rank != owner(P)) {   // the panel's swaps, as the owner made them
#pragma unroll
        for (int m = 0; m < kNb; ++m) {
          const uint4 t = pqr[m];
          if (tid == static_cast<int>(t.x)) mypos = P * kNb + m;
          else if (mypos == P * kNb + m) mypos = static_cast<int>(t.y);
        }
      } else {
        act &= ~(3u << (lcol(P) / 8));
      }
    }

    // B': panel P's pivot rows through its steps on column j, four lanes a
    // column (lane g = tid % 4 holds pivot rows 4g .. 4g + 3; the holder of
    // step m's row sends its u to the others by a shuffle): the u of each
    // step into U, the rows' new values; a whole warp calls it
    auto bprime = [&](int j) {
      __syncwarp();
      const int g = tid & 3;
      const int quad = lane & ~3;
      float r[4], us[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = slab[pqr[4 * g + i].x * kLd + j];
#pragma unroll
      for (int m = 0; m < kNb; ++m) {
        const float4 f4 = *reinterpret_cast<const float4*>(Fp + m * kNb + 4 * g);
        const float fp[4] = {f4.x, f4.y, f4.z, f4.w};
        const bool own = (m >> 2) == g;
        const float cand = __fmul_rn(r[m & 3], __uint_as_float(pqr[m].z));
        const float u = __shfl_sync(0xffffffffu, cand, quad | (m >> 2));
        if (own) { r[m & 3] = u; us[m & 3] = u; }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!own || i != (m & 3)) r[i] = __fsub_rn(r[i], __fmul_rn(fp[i], u));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        U[(4 * g + i) * kW + j] = us[i];
        slab[pqr[4 * g + i].x * kLd + j] = r[i];
      }
      __syncwarp();
    };

    if (ahead) {
      const int lcn = lcol(N);
      if (P >= 0) {
        // -- phase: look-ahead, B' on the next panel's columns
        if (warp < 2) bprime(lcn + (tid >> 2));
        __syncthreads();
        act &= ~(3u << (lcn / 8));
      }
      // -- phase: look-ahead, B on the next panel's columns (A's load)
      float v[kNb];
      get_row(slab + tid * kLd + lcn, v);
      if (P >= 0 && !((pmask[warp] >> lane) & 1u)) {
        float t[kNb];
#pragma unroll
        for (int m = 0; m < kNb; ++m) {
          const float fm = F[m * SB + tid];
          float u[kNb];
          get_row(U + m * kW + lcn, u);
#pragma unroll
          for (int c = 0; c < kNb; ++c)
            t[c] = m == 0 ? __fmul_rn(fm, u[c])
                          : __fadd_rn(t[c], __fmul_rn(fm, u[c]));
        }
#pragma unroll
        for (int c = 0; c < kNb; ++c) v[c] = __fsub_rn(v[c], t[c]);
      }

      // A: factor panel N; the scaled-row copies take turns between the
      // panel's slab columns (row stride kLd) and its multiplier buffer
      // (rows of 16, swizzled), both free while v is in registers
      const int nb = N & 1;
      float* FN = reinterpret_cast<float*>(buf(nb));
      unsigned char* HN = buf(nb) + C::kFBytes;
      float* cp0 = slab + lcn;
      float* cp1 = FN;
      float f[kNb];
      int my_step = -1;
      const int k0 = N * kNb;
      // -- phase: A, the first column's pivot search
      float x = v[0];
      unsigned hi = pivot_key(x, mypos, k0);
      unsigned lo = ((0xFFFFu - mypos) << 16) | static_cast<unsigned>(tid);
      warp_max(hi, lo);
#pragma unroll
      for (int m = 0; m < kNb; ++m) {
        const int k = k0 + m;
        // -- phase: A, the reciprocal and the scaled copy
        f[m] = x;
        float u[kNb];
        const float rx = __frcp_rn(x);
#pragma unroll
        for (int c = 0; c < kNb; ++c) u[c] = c == m ? rx : __fmul_rn(v[c], rx);
        if (m & 1) put_row<true>(cp1 + tid * kNb, u, tid);
        else put_row(cp0 + tid * kLd, u);
        unsigned* rb = red + (m & 1) * 2 * kMaxWarps;
        if (lane == 0) { rb[2 * warp] = hi; rb[2 * warp + 1] = lo; }
        // -- phase: A, the block barrier
        __syncthreads();
        // -- phase: A, the warps' pairs
        hi = lane < C::kWarps ? rb[2 * lane] : 0u;
        lo = lane < C::kWarps ? rb[2 * lane + 1] : 0u;
        warp_max(hi, lo);
        const int p = static_cast<int>(lo & 0xFFFFu);
        const int q = 0xFFFF - static_cast<int>(lo >> 16);
        // -- phase: A, the pivot row's read
        if (m & 1) get_row<true>(cp1 + p * kNb, u, p);
        else get_row(cp0 + p * kLd, u);
        // -- phase: A, the update
        if (tid == p) { mypos = k; my_step = m; }
        else if (mypos == k) mypos = q;
        if (m + 1 < kNb) {        // the next column first, and its search
          v[m + 1] = tid == p ? u[m + 1]
                              : __fsub_rn(v[m + 1], __fmul_rn(x, u[m + 1]));
          // -- phase: A, the next column's pivot search
          hi = pivot_key(v[m + 1], mypos, k + 1);
          lo = ((0xFFFFu - mypos) << 16) | static_cast<unsigned>(tid);
          warp_max(hi, lo);
          // -- phase: A, the update
        }
#pragma unroll
        for (int c = 0; c < kNb; ++c)
          if (c != m + 1) v[c] = __fsub_rn(c == m ? 0.0f : v[c], __fmul_rn(x, u[c]));
        if (warp == (p >> 5)) {     // the pivot row becomes u (a warp's branch)
#pragma unroll
          for (int c = 0; c < kNb; ++c)
            if (c != m + 1 && tid == p) v[c] = u[c];
        }
        if (tid == 0)
          reinterpret_cast<uint4*>(HN)[m] = make_uint4(
              static_cast<unsigned>(p), static_cast<unsigned>(q),
              __float_as_uint(u[m]), 0u);
        if (m + 1 < kNb) x = v[m + 1];
      }
      // -- phase: A's end, the panel's header and multipliers
      put_row(slab + tid * kLd + lcn, v);
      if (my_step >= 0) {       // a pivot row: its multipliers are fp's column
        float* FpN = reinterpret_cast<float*>(HN + C::kHdrFp);
#pragma unroll
        for (int m = 0; m < kNb; ++m) FpN[m * kNb + my_step] = f[m];
      }
      const unsigned wm = __ballot_sync(0xffffffffu, my_step >= 0);
      if (lane == 0) reinterpret_cast<unsigned*>(HN + C::kHdrMask)[warp] = wm;
      __syncthreads();          // the copies are read: the buffer takes F
#pragma unroll
      for (int m = 0; m < kNb; ++m) FN[m * SB + tid] = f[m];
      if (kC > 1) {
        // the buffer goes to every other CTA by bulk copies, once they
        // have read panel N - 2 from theirs
        fence_proxy_async();
        // -- phase: A's end, waiting for the other CTAs
        if (N >= 2) {
          mbar_wait(empty(nb), (eph >> nb) & 1);
          eph ^= 1u << nb;
        }
        __syncthreads();
        // -- phase: A's end, the panel sent
        if (tid == 0) {
          const unsigned off = static_cast<unsigned>(C::kB + nb * C::kBuf);
          const unsigned offFull = full(nb) - saddr(smem);
#pragma unroll
          for (int i = 1; i < kC; ++i)
            bulk_copy(rbase[i] + off, saddr(buf(nb)), C::kBuf,
                      rbase[i] + offFull);
        }
      }
    }

    if (P >= 0) {
      // -- phase: B' (pivot rows)
      for (int j = tid >> 2; j < kW; j += SB / 4)
        if ((act >> (j / 8)) & 1u) bprime(j);   // a warp's 8 columns alike
      __syncthreads();
      // -- phase: B (other rows)
      // B: the other rows, an 8 x 8 block a thread over the active column
      // blocks: the panel's products summed in step order, then
      // subtracted once
      const int n_act = __popc(act);
      const int ty = tid / n_act, ci = tid - ty * n_act;
      if (ty < SB / 8) {
        int cb = 0;
#pragma unroll
        for (int i = 0, seen = 0; i < kW / 8; ++i)
          if ((act >> i) & 1u) { if (seen == ci) cb = i; ++seen; }
        float t[8][8];
#pragma unroll
        for (int m = 0; m < kNb; ++m) {
          const float4* fs = reinterpret_cast<const float4*>(F + m * SB + 8 * ty);
          const float4* us = reinterpret_cast<const float4*>(U + m * kW + 8 * cb);
          const float4 f0 = fs[0], f1 = fs[1], u0 = us[0], u1 = us[1];
          const float fv[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
          const float uv[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              t[i][j] = m == 0 ? __fmul_rn(fv[i], uv[j])
                               : __fadd_rn(t[i][j], __fmul_rn(fv[i], uv[j]));
        }
        const unsigned piv = (pmask[ty / 4] >> (8 * (ty % 4))) & 0xFFu;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if ((piv >> i) & 1u) continue;   // a pivot row: B' wrote it
          float4* s = reinterpret_cast<float4*>(slab + (8 * ty + i) * kLd +
                                                8 * cb);
          const float4 lo = s[0], hi = s[1];
          s[0] = make_float4(__fsub_rn(lo.x, t[i][0]), __fsub_rn(lo.y, t[i][1]),
                             __fsub_rn(lo.z, t[i][2]), __fsub_rn(lo.w, t[i][3]));
          s[1] = make_float4(__fsub_rn(hi.x, t[i][4]), __fsub_rn(hi.y, t[i][5]),
                             __fsub_rn(hi.z, t[i][6]), __fsub_rn(hi.w, t[i][7]));
        }
      }
      __syncthreads();
      // -- phase: panel P's buffer released
      if (kC > 1 && tid == 0 && P + 2 < C::kPanels) {
        arm(P + 2);
        const unsigned w = owner(P + 2);
        if (w != rank) mbar_arrive_remote(remote(empty(b), w));
      }
    }
  }

  // -- phase: the output
  // the inverse: row pos[r] is the tile's row r, column perm[g] its
  // column g (perm[pos[r]] = r); the multipliers' buffers are free now
  int* pos = reinterpret_cast<int*>(buf(0));
  int* perm = pos + SB;
  pos[tid] = mypos;
  perm[mypos] = tid;
  __syncthreads();
  O* ot = out + static_cast<long long>(tile) * out_ts;
  for (int e = tid; e < SB * kW; e += SB) {
    const int r = e / kW, c = e % kW;
    ot[static_cast<long long>(pos[r]) * out_rs + perm[gcol(c)]] =
        cvt<O>(slab[r * kLd + c]);
  }
  if (kC > 1) {                 // no CTA leaves while another may reach it
    cluster_arrive();
    cluster_wait();
  }
}

template <int SB, typename O>
cudaError_t prepare(int* max_clusters) {
  using C = Cfg<SB>;
  constexpr int kDevices = 64;
  static bool ready[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevices || !ready[dev]) {
    e = cudaFuncSetAttribute(bj_inverse_kernel<SB, O>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kBytes));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(bj_inverse_kernel<SB, O>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    if (dev < kDevices) ready[dev] = true;
  }
  if (max_clusters == nullptr) return cudaSuccess;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C::kCtas);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kBytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(max_clusters,
                                        bj_inverse_kernel<SB, O>, &cfg);
}

template <int SB, typename O>
int inverse_launch(const void* a, void* out, int n_tiles, long long out_ts,
                   int out_rs, cudaStream_t s) {
  using C = Cfg<SB>;
  const long long grid = static_cast<long long>(n_tiles) * C::kCtas;
  if (grid > 0x7fffffffLL) return -1;
  cudaError_t e = prepare<SB, O>(nullptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kBytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, bj_inverse_kernel<SB, O>,
                         static_cast<const float*>(a), static_cast<O*>(out),
                         out_ts, out_rs);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int inverse_sb(const void* a, void* out, int sb, int n_tiles,
               long long out_ts, int out_rs, cudaStream_t s) {
  switch (sb) {
    case 64: return inverse_launch<64, O>(a, out, n_tiles, out_ts, out_rs, s);
    case 128: return inverse_launch<128, O>(a, out, n_tiles, out_ts, out_rs, s);
    case 256: return inverse_launch<256, O>(a, out, n_tiles, out_ts, out_rs, s);
    case 512: return inverse_launch<512, O>(a, out, n_tiles, out_ts, out_rs, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// The inverses of the fp32 tiles a (n_tiles, sb, sb), contiguous, 16-byte
// aligned, into out (row-major tiles at tile stride out_ts and row stride
// out_rs, in elements) in fp32 (out_kind 1), bf16 (2) or fp64 (3).
// Returns cudaGetLastError() after the launch, or -1 for an SB or output
// without an instantiation.  Does not synchronise.
int nst_bj_inverse(const void* a, void* out, int sb, int n_tiles,
                   int out_kind, long long out_ts, int out_rs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 1: return inverse_sb<float>(a, out, sb, n_tiles, out_ts, out_rs, s);
    case 2:
      return inverse_sb<__nv_bfloat16>(a, out, sb, n_tiles, out_ts, out_rs, s);
    case 3: return inverse_sb<double>(a, out, sb, n_tiles, out_ts, out_rs, s);
    default: return -1;
  }
}

// The clusters (tiles) of the fp32-output kernel at tiles of sb that the
// card holds at once, into *clusters.
int nst_bj_inverse_occupancy(int sb, int* clusters) {
  switch (sb) {
    case 64: return static_cast<int>(prepare<64, float>(clusters));
    case 128: return static_cast<int>(prepare<128, float>(clusters));
    case 256: return static_cast<int>(prepare<256, float>(clusters));
    case 512: return static_cast<int>(prepare<512, float>(clusters));
    default: return -1;
  }
}

}  // extern "C"
