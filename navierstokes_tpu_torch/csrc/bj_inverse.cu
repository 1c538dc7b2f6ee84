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
// even) or fp64.
//
// Design: a 256 x 256 fp32 tile (256 KB) does not fit one CTA's shared
// memory, so a tile is a cluster of SB / 64 CTAs, each holding 64 columns
// of all SB rows in shared memory (68 floats a row: 16-byte aligned rows,
// a column's reads spread over 8 banks).  The columns are eliminated in
// panels of 16, each owned by the CTA that holds them:
//   A   the owner factors the panel, a thread per row holding the row's
//       16 panel values in registers, one block barrier per column: before
//       it each row writes itself scaled by its own reciprocal into a copy
//       in shared memory (double-buffered, in the owner's multiplier
//       buffers, free until the push) and each warp takes its largest
//       (key, position) pair by two redux.sync; after it the warps' pairs
//       give the pivot, whose scaled row is one read, and every row updates
//       its 16 values; then each row's 16 multipliers f and the 16 (pivot,
//       position) pairs are pushed into every CTA of the cluster (DSMEM);
//   -   one cluster barrier per panel (the multipliers are double-buffered,
//       so the next owner may write while this panel is being applied);
//   B'  every CTA takes the 16 pivot rows through the panel's 16 steps on
//       its own columns, sequentially in the steps, a thread per column:
//       the u_j of each step and the pivot rows' new values (products and
//       differences only: the 16 reciprocals are taken once);
//   B   every CTA updates its other rows: each thread sums the 16 steps'
//       products of an 8 x 8 block in registers, reading 8 f and 8 u per
//       step (16-byte loads, 128 operations per 4 loads), and subtracts
//       them from the block once.
// The inverse's rows and columns are written in their final places, in the
// output dtype, at the caller's tile and row strides (row-major tiles).
// A cluster never reads another tile, so a tile's inverse does not depend
// on the batch it sits in.  SB = 64, 128, 256 or 512 (clusters of 1, 2, 4
// or 8 CTAs; at 256 the card holds 62 clusters at once).
// Measured (PERF.md section 6): 7.4 ms at the bench point's tiles, 8.4x the
// bound.  A's sequential pivot search holds it: about 1,100 clocks a column
// on the owner while the cluster's other CTAs wait (tools/
// bj_inverse_profile.py splits the clocks by phase).

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
  static constexpr int kOwnPanels = kW / kNb;
  // shared memory, in bytes from the start
  static constexpr size_t kSlab = 0;                                 // SB x kLd f32
  static constexpr size_t kF = kSlab + size_t(SB) * kLd * 4;         // 2 x kNb x SB f32
  static constexpr size_t kU = kF + size_t(2) * kNb * SB * 4;        // kNb x kW f32
  static constexpr size_t kFp = kU + size_t(kNb) * kW * 4;           // kNb x kNb f32
  static constexpr size_t kRdp = kFp + size_t(kNb) * kNb * 4;        // kNb f32
  static constexpr size_t kPq = kRdp + kNb * 4;                      // 2 x kNb x 2 i32
  static constexpr size_t kRed = kPq + 2 * kNb * 2 * 4;              // 2 x kMaxWarps x 2 u32
  static constexpr size_t kStep = kRed + 2 * kMaxWarps * 2 * 4;      // SB i32
  static constexpr size_t kBytes = kStep + size_t(SB) * 4;
  static_assert(SB % kW == 0 && kCtas <= 8, "SB = 64 .. 512");
  static_assert(kWarps <= kMaxWarps, "at most 16 warps");
  static_assert(kF % 16 == 0 && kU % 16 == 0 && kPq % 16 == 0, "aligned");
  static_assert(kBytes <= 232448, "one CTA's shared memory");
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
// the address of `p` (this CTA's shared memory) in CTA `rank`'s
__device__ __forceinline__ unsigned remote(const void* p, unsigned rank) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void store_remote(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(addr), "f"(v)
               : "memory");
}
__device__ __forceinline__ void store_remote(unsigned addr, int v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" :: "r"(addr), "r"(v)
               : "memory");
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
  return pos < k ? 0u : isnan(x) ? 1u : __float_as_uint(fabsf(x)) + 2u;
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
  extern __shared__ __align__(16) unsigned char smem[];
  float* slab = reinterpret_cast<float*>(smem + C::kSlab);
  float* Fb = reinterpret_cast<float*>(smem + C::kF);
  float* U = reinterpret_cast<float*>(smem + C::kU);
  float* Fp = reinterpret_cast<float*>(smem + C::kFp);
  float* rdp = reinterpret_cast<float*>(smem + C::kRdp);
  int* pq = reinterpret_cast<int*>(smem + C::kPq);
  unsigned* red = reinterpret_cast<unsigned*>(smem + C::kRed);
  int* pstep = reinterpret_cast<int*>(smem + C::kStep);

  const unsigned rank = cluster_rank();
  const size_t tile = blockIdx.x / C::kCtas;
  const int c0 = static_cast<int>(rank) * kW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cluster_arrive_relaxed();     // this CTA runs: others may store into it

  // this CTA's 64 columns of the tile
  const float* at = a + tile * SB * SB;
  for (int e = tid; e < SB * (kW / 4); e += SB) {
    const int r = e / (kW / 4), c4 = e % (kW / 4);
    *reinterpret_cast<float4*>(slab + r * kLd + 4 * c4) =
        *reinterpret_cast<const float4*>(at + static_cast<size_t>(r) * SB +
                                         c0 + 4 * c4);
  }
  int mypos = tid;              // the position of row tid
  __syncthreads();
  cluster_wait();

  const int tx = tid % 8, ty = tid / 8;   // B: columns 8 tx.., rows 8 ty..
  for (int P = 0; P < C::kPanels; ++P) {
    const unsigned owner = P / C::kOwnPanels;
    const int lc0 = (P % C::kOwnPanels) * kNb;  // the owner's local column
    const int k0 = P * kNb;
    float* F = Fb + (P & 1) * kNb * SB;         // F[m * SB + row]
    int* pqb = pq + (P & 1) * 2 * kNb;          // (pivot row, position)
    if (rank == owner) {
      // A: row tid's panel values in registers; before each column's
      // barrier every row also writes itself scaled by its own reciprocal
      // (u = v r, u_m = r = 1 / v_m) into a double-buffered copy (the
      // owner's multiplier buffers, both free until the push), so that
      // after the barrier the pivot row's u is one read
      float v[kNb], f[kNb];
      get_row(slab + tid * kLd + lc0, v);
      int my_p = 0, my_q = 0;
#pragma unroll
      for (int m = 0; m < kNb; ++m) {
        const int k = k0 + m;
        const float x = v[m];
        float u[kNb];
        const float rx = __frcp_rn(x);
#pragma unroll
        for (int c = 0; c < kNb; ++c) u[c] = c == m ? rx : __fmul_rn(v[c], rx);
        float* ub = Fb + (m & 1) * kNb * SB;
        put_row<true>(ub + tid * kNb, u, tid);
        unsigned hi = pivot_key(x, mypos, k);
        unsigned lo = ((0xFFFFu - mypos) << 16) | static_cast<unsigned>(tid);
        warp_max(hi, lo);
        unsigned* rb = red + (m & 1) * 2 * kMaxWarps;
        if (lane == 0) { rb[2 * warp] = hi; rb[2 * warp + 1] = lo; }
        __syncthreads();
        hi = lane < C::kWarps ? rb[2 * lane] : 0u;
        lo = lane < C::kWarps ? rb[2 * lane + 1] : 0u;
        warp_max(hi, lo);
        const int p = static_cast<int>(lo & 0xFFFFu);
        const int q = 0xFFFF - static_cast<int>(lo >> 16);
        get_row<true>(ub + p * kNb, u, p);        // the pivot row's u
        f[m] = x;
        if (tid == p) {
#pragma unroll
          for (int c = 0; c < kNb; ++c) v[c] = u[c];
        } else {
#pragma unroll
          for (int c = 0; c < kNb; ++c)
            v[c] = __fsub_rn(c == m ? 0.0f : v[c], __fmul_rn(x, u[c]));
        }
        if (tid == p) mypos = k;
        else if (mypos == k) mypos = q;
        if (tid == m) { my_p = p; my_q = q; }
      }
      put_row(slab + tid * kLd + lc0, v);
      __syncthreads();          // the copies are read: the push may land
      for (unsigned r = 0; r < C::kCtas; ++r) {
#pragma unroll
        for (int m = 0; m < kNb; ++m)
          store_remote(remote(F + m * SB + tid, r), f[m]);
        if (tid < kNb) {
          store_remote(remote(pqb + 2 * tid, r), my_p);
          store_remote(remote(pqb + 2 * tid + 1, r), my_q);
        }
      }
    }
    cluster_arrive();
    cluster_wait();

    // the panel's (pivot row, position) pairs
    int pv[kNb], qv[kNb];
#pragma unroll
    for (int m4 = 0; m4 < kNb / 2; ++m4) {
      const int4 t = reinterpret_cast<const int4*>(pqb)[m4];
      pv[2 * m4] = t.x; qv[2 * m4] = t.y;
      pv[2 * m4 + 1] = t.z; qv[2 * m4 + 1] = t.w;
    }
    if (rank != owner) {        // the panel's swaps, as the owner made them
#pragma unroll
      for (int m = 0; m < kNb; ++m) {
        if (tid == pv[m]) mypos = k0 + m;
        else if (mypos == k0 + m) mypos = qv[m];
      }
    }
    int st = -1;
#pragma unroll
    for (int m = 0; m < kNb; ++m) st = pv[m] == tid ? m : st;
    pstep[tid] = st;
    for (int t = tid; t < kNb * kNb; t += SB)
      Fp[t] = F[(t / kNb) * SB + pqb[2 * (t % kNb)]];
    if (tid < kNb) rdp[tid] = __frcp_rn(F[tid * SB + pqb[2 * tid]]);
    __syncthreads();

    const bool own_panel = rank == owner;
    // B': the pivot rows through the panel's steps, a thread per column
    if (tid < kW && !(own_panel && tid >= lc0 && tid < lc0 + kNb)) {
      float r[kNb];
#pragma unroll
      for (int m = 0; m < kNb; ++m) r[m] = slab[pv[m] * kLd + tid];
#pragma unroll
      for (int m = 0; m < kNb; ++m) {
        float fp[kNb];
        get_row(Fp + m * kNb, fp);
        const float u = __fmul_rn(r[m], rdp[m]);
        r[m] = u;
        U[m * kW + tid] = u;
#pragma unroll
        for (int m2 = 0; m2 < kNb; ++m2)
          if (m2 != m) r[m2] = __fsub_rn(r[m2], __fmul_rn(fp[m2], u));
      }
#pragma unroll
      for (int m = 0; m < kNb; ++m) slab[pv[m] * kLd + tid] = r[m];
    }
    __syncthreads();

    // B: the other rows, an 8 x 8 block a thread: the panel's products
    // summed in step order, then subtracted once
    if (!(own_panel && 8 * tx >= lc0 && 8 * tx < lc0 + kNb)) {
      float t[8][8];
#pragma unroll
      for (int m = 0; m < kNb; ++m) {
        const float4* fs = reinterpret_cast<const float4*>(F + m * SB + 8 * ty);
        const float4* us = reinterpret_cast<const float4*>(U + m * kW + 8 * tx);
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
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (pstep[8 * ty + i] >= 0) continue;   // a pivot row: B' wrote it
        float4* s = reinterpret_cast<float4*>(slab + (8 * ty + i) * kLd +
                                              8 * tx);
        const float4 lo = s[0], hi = s[1];
        s[0] = make_float4(__fsub_rn(lo.x, t[i][0]), __fsub_rn(lo.y, t[i][1]),
                           __fsub_rn(lo.z, t[i][2]), __fsub_rn(lo.w, t[i][3]));
        s[1] = make_float4(__fsub_rn(hi.x, t[i][4]), __fsub_rn(hi.y, t[i][5]),
                           __fsub_rn(hi.z, t[i][6]), __fsub_rn(hi.w, t[i][7]));
      }
    }
    __syncthreads();
  }

  // the inverse: row pos[r] is the tile's row r, column perm[g] its
  // column g (perm[pos[r]] = r); the multipliers' buffer is free now
  int* pos = reinterpret_cast<int*>(Fb);
  int* perm = pos + SB;
  pos[tid] = mypos;
  perm[mypos] = tid;
  __syncthreads();
  O* ot = out + static_cast<long long>(tile) * out_ts;
  for (int e = tid; e < SB * kW; e += SB) {
    const int r = e / kW, c = e % kW;
    ot[static_cast<long long>(pos[r]) * out_rs + perm[c0 + c]] =
        cvt<O>(slab[r * kLd + c]);
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
