// FGMRES's two-pass modified Gram-Schmidt on the card (sm_90a), over the
// live rows of the basis only.
//
// Replaces no Pallas kernel: the JAX package's Arnoldi step runs the two
// passes "vectorized over the full static basis with an index mask"
// (navierstokes_tpu/solvers/krylov.py:95-103), which XLA fuses; the port's
// plain version (kernels/gram_schmidt.py) runs them as four products over
// all m + 1 rows of V, although rows j + 1..m are zero.  Here j is read
// from the device, so no launch argument varies between iterations or
// cycles (one captured while body serves every cycle, as with
// csrc/arnoldi_lsq.cu), and only rows 0..j are read.  Four launches:
//
//   gs_pass<0>   each tile's (256 elements) dots of rows 0..j with w,
//                summed into 256 owner sums per row;
//   gs_pass<1>   h1 from those sums (every CTA; CTA 0 stores it, 0
//                beyond j: the JAX mask's zeros); w1 = w - sum_i h1[i]
//                V[i] on each tile (into a scratch vector), the tile's
//                dots of rows 0..j with w1, summed into owner sums;
//   gs_pass<2>   h2 likewise; w2 = w1 - sum_i h2[i] V[i], the owner sums
//                of w2^2;
//   gs_write     ||w2|| from them (CTA 0 stores it), and while `active`:
//                V[min(j+1, m)] = w2 / max(||w2||, 1e-30) and, for FGMRES,
//                Z[min(j, m-1)] = z.
//
// The sums are those of the first, six-launch design, so the bits are
// too.  Every product is summed in float64, for float32 data too (a
// product of two floats is exact there, so the result rounded once hardly
// depends on the order, and the plain version, which sums in float64 in
// BLAS's order, agrees with it to within an ulp), in one fixed order: a
// tile's dot is eight lane FMAs (elements lane + 32 c) and a xor
// butterfly; a row's 3,963 tile partials (n = 1,014,414) are summed by
// 256 owners, owner c taking tiles c, c + 256, ... in turn (the first
// design's reduce thread c), and the 256 owner sums in the order of one
// 256-thread CTA sum (a butterfly per warp, the warps in order).  Each
// pass runs exactly 256 CTAs, CTA c the owner c; its warps take its tiles
// in turn and the CTA adds their partials to its owner sums in tile
// order.  The next launch sums the owner sums, in every CTA (the same
// order, the same bits): no atomics, no counter, no last-CTA step.
//
// Bound: bytes.  The function reads rows 0..j of V, w and z once and
// writes one row of V and of Z.  The passes read rows 0..j three times,
// the first pass's dots a fourth time except the rows the update left in
// the ring (from the L2 where it still holds them).  Each warp streams
// its tile's rows through a ring of its own with 16-byte cp.async
// copies: in the streaming passes 16 warps a CTA with 4 rows of 1 KB
// (fp32) or 2 of 2 KB (fp64) each; in the first update pass, whose dots
// want the rows again, 8 (fp32) or 4 (fp64) warps with 11 rows each.
// Two CTAs share an SM, so an SM keeps up to 128-176 KB in flight, and a
// warp's first tile's vector and row 0 are in flight before j and the
// coefficients are read.  Measured (PERF.md section 6): at small j the
// four launches' fixed costs, not the bytes, set the time.  The basis
// rows must start on 16-byte boundaries, which the padded basis
// (kernels/gram_schmidt.basis: a row stride of a multiple of 32
// elements) gives; w, which the product hands over, may be only
// element-aligned and is then copied element by element.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kTile = 256;                // elements per tile partial
constexpr int kOwners = 256;              // CTAs of a pass
constexpr int kPerLane = kTile / 32;      // a lane's elements of a tile
constexpr int kWriteThreads = 256;
// tiles whose partials a pass's CTA holds at once (a round): a multiple
// of every pass's warps, and the 16 tiles an owner takes of the bench
// vector (n = 1,014,414) in one round
constexpr int kRound = 16;

// A pass's warps per CTA and ring depth (rows of a warp's tile in its
// ring).  The streaming passes (0, 2) take many warps and short rings;
// the first update pass (1) takes fewer warps with deep rings, so that
// its dots find up to 11 of the tile's rows still in the ring.  At
// restart 64 every pass's CTA takes under 113 KB, so two share an SM.
template <typename T, int MODE> struct Cfg {
  static constexpr int kWarps = MODE == 1 ? (sizeof(T) == 4 ? 8 : 4) : 16;
  static constexpr int kDepth = MODE == 1 ? 11 : (sizeof(T) == 4 ? 4 : 2);
  static constexpr int kThreads = kWarps * 32;
};

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

// The 256 owner sums s[0..255] of one row summed as one 256-thread CTA
// sum (a butterfly per warp of 32, the eight warps in order), by one warp;
// every lane gets it.
__device__ double owner_sum(const double* s, int lane) {
  double a[kOwners / 32];
#pragma unroll
  for (int w = 0; w < kOwners / 32; ++w) a[w] = __ldcg(s + 32 * w + lane);
#pragma unroll
  for (int w = 0; w < kOwners / 32; ++w) a[w] = warp_sum(a[w]);
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < kOwners / 32; ++w) t = __dadd_rn(t, a[w]);
  return t;
}

__device__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

template <int B> __device__ void cp_small(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(B)
               : "memory");
}

__device__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ void wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp's copy of cnt elements from src into dst: 16-byte copies while
// `vec` (src 16-byte aligned), the rest element by element.
template <typename T>
__device__ void stage(T* dst, const T* src, int cnt, bool vec, int lane) {
  constexpr int kPer16 = 16 / sizeof(T);
  int done = 0;
  if (vec) {
    const int chunks = cnt / kPer16;
    for (int c = lane; c < chunks; c += 32)
      cp16(dst + c * kPer16, src + c * kPer16);
    done = chunks * kPer16;
  }
  for (int e = done + lane; e < cnt; e += 32)
    cp_small<sizeof(T)>(dst + e, src + e);
}

// The element e of a tile's smem copy, 0 past the tile's end (the first
// design staged zeros there).
template <typename T> __device__ T at(const T* s, int e, int cnt) {
  return e < cnt ? s[e] : T(0);
}

// The dots of K staged rows with the staged vector, each in the lanes'
// fixed order (eight FMAs, then a xor butterfly), the rows interleaved;
// every lane gets them.
template <typename T, int K>
__device__ void tile_dots(const T* const (&rows)[K], const T* x, int cnt,
                          int lane, double (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = 0.0;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const int e = lane + 32 * c;
    const double xe = static_cast<double>(at(x, e, cnt));
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[k] = __fma_rn(static_cast<double>(at(rows[k], e, cnt)), xe, out[k]);
  }
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[k] = __dadd_rn(out[k], __shfl_xor_sync(0xffffffffu, out[k], o));
  }
}

template <typename T>
__device__ double tile_dot(const T* row, const T* x, int cnt, int lane) {
  const T* rows[1] = {row};
  double out[1];
  tile_dots<T, 1>(rows, x, cnt, lane, out);
  return out[0];
}

// Dynamic shared memory of a pass for `rows` rows: each warp's ring of
// kDepth rows and its vector (w, w1); then the partials of a round's
// kRound tiles (rows doubles each), the CTA's owner sums and the
// coefficients.
template <typename T, int MODE>
__host__ __device__ constexpr size_t ring_bytes() {
  return static_cast<size_t>(Cfg<T, MODE>::kWarps) *
         (Cfg<T, MODE>::kDepth + 1) * kTile * sizeof(T);
}
template <typename T, int MODE> size_t pass_smem(int rows) {
  return ring_bytes<T, MODE>() +
         static_cast<size_t>(rows) * (kRound + 2) * sizeof(double);
}

// MODE 0: sums_out[i][c] = owner c's sum of row i's dots with w, i <= j.
// MODE 1: h = the owner sums of sums_in (h_out, written by CTA 0);
//         w_out = w_in - sum_i h[i] V[i]; sums_out as MODE 0 with w_out.
// MODE 2: h as MODE 1; w_out = w_in - sum_i h[i] V[i]; sums_out[c] =
//         owner c's sum of the squares of w_out.
// (w_in and w_out may be the same vector: a warp reads its tile's
// elements before it writes them.)  Owner c is CTA c; the CTA's warps
// take its tiles c + 256 q, q = 0, 1, ..., kWarps at a time, kRound
// tiles a round, and the CTA adds their partials in q order (the round's
// size moves no bit).
template <typename T, int MODE>
__global__ void __launch_bounds__(Cfg<T, MODE>::kThreads, 2)
gs_pass(const T* __restrict__ V, long long ld, const T* w_in, int w_vec,
        T* w_out, const double* __restrict__ sums_in, T* __restrict__ h_out,
        double* __restrict__ sums_out, const int* __restrict__ j_ptr, int m,
        long long n) {
  constexpr int D = Cfg<T, MODE>::kDepth;
  constexpr int kWarps = Cfg<T, MODE>::kWarps;
  constexpr int kThreads = Cfg<T, MODE>::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* slots = reinterpret_cast<T*>(smem) + warp * (D + 1) * kTile;
  T* sx = slots + D * kTile;
  double* part = reinterpret_cast<double*>(smem + ring_bytes<T, MODE>());
  double* own = part + static_cast<size_t>(kRound) * (m + 1);
  double* hd = own + (m + 1);

  const long long tiles = (n + kTile - 1) / kTile;
  const int c = blockIdx.x;
  const long long Q = tiles > c ? (tiles - 1 - c) / kOwners + 1 : 0;
  auto tile_k0 = [&](long long q) { return (c + kOwners * q) * kTile; };
  auto tile_cnt = [&](long long k0) {
    return n - k0 < kTile ? static_cast<int>(n - k0) : kTile;
  };
  auto issue = [&](int i, int slot, long long k0, int cnt) {
    stage(slots + slot * kTile, V + static_cast<long long>(i) * ld + k0, cnt,
          true, lane);
  };
  // the warp's first tile: the vector and row 0 (every call has them)
  // in flight before j and the coefficients are read
  if (warp < Q) {
    const long long k0 = tile_k0(warp);
    stage(sx, w_in + k0, tile_cnt(k0), w_vec != 0, lane);
    issue(0, 0, k0, tile_cnt(k0));
  }
  commit();
  const int j = *j_ptr;
  const int R = (j < m ? j : m) + 1;                 // live rows
  const int P = MODE == 2 ? 1 : R;                   // sums per tile
  if (MODE != 0) {
    // the coefficients of the last pass: every CTA sums the owner sums
    // itself (in one order: the same bits), CTA 0 stores them
    for (int i = warp; i <= m; i += kWarps) {
      const double s = i < R ? owner_sum(sums_in + i * kOwners, lane) : 0.0;
      const T h = to_t<T>(s);
      if (lane == 0) {
        hd[i] = static_cast<double>(h);
        if (c == 0) h_out[i] = h;
      }
    }
  }
  for (int i = threadIdx.x; i < P; i += kThreads) own[i] = 0.0;
  __syncthreads();

  for (long long r0 = 0; r0 < Q; r0 += kRound) {
    const long long r1 = Q - r0 < kRound ? Q : r0 + kRound;
    for (long long q = r0 + warp; q < r1; q += kWarps) {
      const long long k0 = tile_k0(q);
      const int cnt = tile_cnt(k0);
      double* pq = part + (q - r0) * (m + 1);
      // the vector and row 0 in the first group (issued above for the
      // warp's first tile), rows 1..D-1 after
      if (q != warp) {
        stage(sx, w_in + k0, cnt, w_vec != 0, lane);
        issue(0, 0, k0, cnt);
        commit();
      }
      for (int s = 1; s < D; ++s) {
        if (s < R) issue(s, s, k0, cnt);
        commit();
      }
      if (MODE == 0) {
        for (int i = 0; i < R; ++i) {
          wait_prior<D - 1>();
          __syncwarp();
          const double a = tile_dot(slots + (i % D) * kTile, sx, cnt, lane);
          if (lane == 0) pq[i] = a;
          __syncwarp();
          if (i + D < R) issue(i + D, i % D, k0, cnt);
          commit();
        }
      } else {
        double acc[kPerLane];
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) acc[e] = 0.0;
        for (int i = 0; i < R; ++i) {
          wait_prior<D - 1>();
          __syncwarp();
          const T* row = slots + (i % D) * kTile;
          const double hi = hd[i];
#pragma unroll
          for (int e = 0; e < kPerLane; ++e)
            acc[e] = __fma_rn(hi, static_cast<double>(at(row, lane + 32 * e,
                                                         cnt)),
                              acc[e]);
          __syncwarp();
          if (i + D < R) issue(i + D, i % D, k0, cnt);
          commit();
        }
        double sq = 0.0;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) {
          const int k = lane + 32 * e;
          const T x = to_t<T>(__dsub_rn(static_cast<double>(at(sx, k, cnt)),
                                        acc[e]));
          if (k < cnt) w_out[k0 + k] = x;
          if (MODE == 1) {
            sx[k] = x;
          } else {
            // the first design's CTA sum of the squares: warp e of its
            // CTA held the elements 32 e + lane
            sq = __dadd_rn(sq, warp_sum(__dmul_rn(static_cast<double>(x),
                                                  static_cast<double>(x))));
          }
        }
        if (MODE == 2) {
          if (lane == 0) pq[0] = sq;
        } else {
          // the dots with w1: rows R-1 down to 0 (step k takes row
          // R-1-k), the last min(R, D) still in the ring, the others
          // staged again into the slots the first steps free.  Every step
          // commits one group, so the row staged at step k - D is the
          // oldest but D - 1 at step k.
          __syncwarp();
          auto single = [&](int k) {
            const int r = R - 1 - k;
            if (k >= D) wait_prior<D - 1>();
            __syncwarp();
            const double a = tile_dot(slots + (r % D) * kTile, sx, cnt, lane);
            if (lane == 0) pq[r] = a;
            __syncwarp();
            if (k + D < R) issue(r - D, r % D, k0, cnt);
            commit();
          };
          int k = 0;
          for (; k + D < R; ++k) single(k);
          // rows still in the ring that free no slot: four at a time
          for (; k + 4 <= R && k + 3 < D; k += 4) {
            const T* rows4[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              rows4[u] = slots + ((R - 1 - k - u) % D) * kTile;
            double a4[4];
            tile_dots<T, 4>(rows4, sx, cnt, lane, a4);
            if (lane == 0) {
#pragma unroll
              for (int u = 0; u < 4; ++u) pq[R - 1 - k - u] = a4[u];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) commit();
          }
          for (; k < R; ++k) single(k);
        }
      }
    }
    __syncthreads();
    // the owner sums, in tile order
    for (int i = threadIdx.x; i < P; i += kThreads) {
      double a = own[i];
      for (long long q = r0; q < r1; ++q)
        a = __dadd_rn(a, part[(q - r0) * (m + 1) + i]);
      own[i] = a;
    }
    __syncthreads();
  }
  wait_prior<0>();
  for (int i = threadIdx.x; i < P; i += kThreads)
    sums_out[static_cast<long long>(i) * kOwners + c] = own[i];
}

// *wnorm = ||w2|| from the owner sums of the squares (every CTA sums them,
// CTA 0 stores it), then while *active: V[min(j+1, m)] = w2 /
// max(||w2||, 1e-30) (NaN passes through, as torch.clamp) and, given Z,
// Z[min(j, m-1)] = z; 16-byte loads and stores where w2, the rows and z
// allow them, the first issued before the norm is known.
template <typename T>
__global__ void __launch_bounds__(kWriteThreads)
gs_write(T* __restrict__ V, long long ld, const T* __restrict__ w2,
         const double* __restrict__ sums, T* __restrict__ wnorm,
         const int* __restrict__ j_ptr, const bool* __restrict__ active,
         const T* __restrict__ z, int z_vec, T* __restrict__ Z, long long ldz,
         int m, long long n) {
  constexpr int W = 16 / sizeof(T);
  using V4 = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
  __shared__ T d_s;
  const long long nv = n / W;
  const long long stride = static_cast<long long>(gridDim.x) * kWriteThreads;
  const long long k_first = blockIdx.x * static_cast<long long>(
                                             kWriteThreads) + threadIdx.x;
  V4 a0;
  if (k_first < nv) a0 = reinterpret_cast<const V4*>(w2)[k_first];
  if (threadIdx.x < 32) {
    const T wn = to_t<T>(__dsqrt_rn(owner_sum(sums, threadIdx.x)));
    if (threadIdx.x == 0) {
      if (blockIdx.x == 0) *wnorm = wn;
      const T lo = T(1e-30);
      d_s = isnan(wn) ? wn : (wn < lo ? lo : wn);
    }
  }
  __syncthreads();
  if (!*active) return;
  const T d = d_s;
  const int j = *j_ptr;
  T* vrow = V + static_cast<long long>(j + 1 < m ? j + 1 : m) * ld;
  T* zrow = Z == nullptr ? nullptr
                         : Z + static_cast<long long>(j < m - 1 ? j : m - 1) *
                                   ldz;
  for (long long k = k_first; k < nv; k += stride) {
    V4 a = k == k_first ? a0 : reinterpret_cast<const V4*>(w2)[k];
    T* e = reinterpret_cast<T*>(&a);
#pragma unroll
    for (int c = 0; c < W; ++c) e[c] = div_rn(e[c], d);
    reinterpret_cast<V4*>(vrow)[k] = a;
    if (zrow != nullptr) {
      if (z_vec) {
        reinterpret_cast<V4*>(zrow)[k] = reinterpret_cast<const V4*>(z)[k];
      } else {
#pragma unroll
        for (int c = 0; c < W; ++c) zrow[W * k + c] = z[W * k + c];
      }
    }
  }
  for (long long k = nv * W + k_first; k < n; k += stride) {
    vrow[k] = div_rn(w2[k], d);
    if (zrow != nullptr) zrow[k] = z[k];
  }
}

// The passes' shared-memory limit raised to the card's opt-in limit (what
// each launch takes depends on m alone, so no call lowers another's); the
// most rows a basis may have into *max_rows.
template <typename T, int MODE> int limit(int optin, int* max_rows) {
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(gs_pass<T, MODE>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows =
      (static_cast<long long>(optin) -
       static_cast<long long>(ring_bytes<T, MODE>())) /
      static_cast<long long>((kRound + 2) * sizeof(double));
  *max_rows = rows < *max_rows ? static_cast<int>(rows) : *max_rows;
  return 0;
}

template <typename T>
int setup(int* info) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int max_rows = 1 << 30;
  int rc = limit<T, 0>(optin, &max_rows);
  if (rc == 0) rc = limit<T, 1>(optin, &max_rows);
  if (rc == 0) rc = limit<T, 2>(optin, &max_rows);
  if (rc != 0) return rc;
  info[0] = sms;
  info[1] = max_rows;
  return 0;
}

template <typename T>
int run(const void* V_, long long ld, const void* w_, int w_vec, void* h1_,
        void* h2_, void* wnorm_, const int* j, const bool* active,
        const void* z_, int z_vec, void* Z_, long long ldz, double* sums,
        void* wbuf_, int m, long long n, int write_ctas, void* stream) {
  if (m < 1 || n < 1) return -1;
  const T* V = static_cast<const T*>(V_);
  const T* w = static_cast<const T*>(w_);
  T* wbuf = static_cast<T*>(wbuf_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = m + 1;
  // two sets of owner sums: a pass reads the last pass's and writes the
  // other
  double* sums_a = sums;
  double* sums_b = sums + static_cast<long long>(rows) * kOwners;
  gs_pass<T, 0><<<kOwners, Cfg<T, 0>::kThreads, pass_smem<T, 0>(rows),
                  s>>>(V, ld, w, w_vec, nullptr, nullptr, nullptr, sums_a, j,
                       m, n);
  gs_pass<T, 1><<<kOwners, Cfg<T, 1>::kThreads, pass_smem<T, 1>(rows),
                  s>>>(V, ld, w, w_vec, wbuf, sums_a, static_cast<T*>(h1_),
                       sums_b, j, m, n);
  gs_pass<T, 2><<<kOwners, Cfg<T, 2>::kThreads, pass_smem<T, 2>(rows),
                  s>>>(V, ld, wbuf, 1, wbuf, sums_b, static_cast<T*>(h2_),
                       sums_a, j, m, n);
  gs_write<T><<<write_ctas, kWriteThreads, 0, s>>>(
      const_cast<T*>(V), ld, wbuf, sums_a, static_cast<T*>(wnorm_), j,
      active, static_cast<const T*>(z_), z_vec, static_cast<T*>(Z_), ldz, m,
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Raises the passes' shared-memory limit on the current device (once per
// device and dtype); info = {SMs, the most rows a basis may have}.
// Returns a cudaError_t.
int nst_gram_schmidt_setup_f32(int* info) { return setup<float>(info); }

int nst_gram_schmidt_setup_f64(int* info) { return setup<double>(info); }

// The Arnoldi step's Gram-Schmidt of w (n) against rows 0..*j of V
// (m + 1 rows of stride ld), see above: h1, h2 (m + 1), *wnorm, and while
// *active V[min(*j + 1, m)] and, given Z (m rows of stride ldz),
// Z[min(*j, m - 1)] = z.  V, Z, their strides and wbuf are 16-byte
// aligned; w_vec / z_vec say whether w / z are.  `sums` holds
// 2 (m + 1) 256 doubles, `wbuf` n values.  Returns the launches'
// cudaError_t, or -1 for m < 1 or n < 1.
int nst_gram_schmidt_f32(const void* V, long long ld, const void* w,
                         int w_vec, void* h1, void* h2, void* wnorm,
                         const int* j, const bool* active, const void* z,
                         int z_vec, void* Z, long long ldz, double* sums,
                         void* wbuf, int m, long long n, int write_ctas,
                         void* stream) {
  return run<float>(V, ld, w, w_vec, h1, h2, wnorm, j, active, z, z_vec, Z,
                    ldz, sums, wbuf, m, n, write_ctas, stream);
}

int nst_gram_schmidt_f64(const void* V, long long ld, const void* w,
                         int w_vec, void* h1, void* h2, void* wnorm,
                         const int* j, const bool* active, const void* z,
                         int z_vec, void* Z, long long ldz, double* sums,
                         void* wbuf, int m, long long n, int write_ctas,
                         void* stream) {
  return run<double>(V, ld, w, w_vec, h1, h2, wnorm, j, active, z, z_vec, Z,
                     ldz, sums, wbuf, m, n, write_ctas, stream);
}

}  // extern "C"
