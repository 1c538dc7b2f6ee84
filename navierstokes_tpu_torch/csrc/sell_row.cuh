// The row loop of the SELL-C-sigma product, shared by csrc/sell_spmv.cu
// (the product alone) and csrc/vcycle.cu (the product with the V-cycle's
// Chebyshev epilogues), so that both sum a row in one order with one
// rounding per product and per sum, and give the same bits.
//
// Layout (ops/sell.py): lane l of a 32-row slice of width w holds slot j at
//   ptr + (j / 4) * 128 + l * 4 + j % 4     for j < 4 * (w / 4),
//   ptr + (w / 4) * 128 + (j % 4) * 32 + l  for the w % 4 last.
// The lane's sum runs over its slots in slot order from zero, one
// accumulator per component, no fused multiply-add.  How the values and
// columns are loaded is the caller's (the load policy below); the sum is
// the same whatever the policy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sell {

constexpr int kC = 32;        // rows per slice (one warp)
constexpr int kG = 4;         // slots per group

// Load policies of the operator's values and columns: Stream reads with
// evict-first loads (__ldcs; the SELL kernel, which reads the operator
// once a product), Keep through the read-only path with the L2's default
// policy (__ldg; the V-cycle's sweep, which reads it again at every
// product of the launch), Plain with ordinary loads (an operator the
// caller copied into shared memory).
struct Stream {
  template <typename U>
  __device__ static U ld(const U* p) { return __ldcs(p); }
};
struct Keep {
  template <typename U>
  __device__ static U ld(const U* p) { return __ldg(p); }
};
struct Plain {
  template <typename U>
  __device__ static U ld(const U* p) { return *p; }
};

// How a stored value meets a gathered x: Acc is the type of x, of the sums
// and of y, and of the values once loaded.
template <typename V>
struct Arith;

template <>
struct Arith<float> {
  using Acc = float;
  template <typename L>
  __device__ static void load_group(const float* p, float a[kG]) {
    const float4 t = L::ld(reinterpret_cast<const float4*>(p));
    a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
  }
  template <typename L>
  __device__ static float load_one(const float* p) { return L::ld(p); }
  __device__ static float x_in(float x) { return x; }
  __device__ static float madd(float a, float x, float acc) {
    return __fadd_rn(acc, __fmul_rn(a, x));
  }
};

template <>
struct Arith<double> {
  using Acc = double;
  template <typename L>
  __device__ static void load_group(const double* p, double a[kG]) {
    const double2 t0 = L::ld(reinterpret_cast<const double2*>(p));
    const double2 t1 = L::ld(reinterpret_cast<const double2*>(p) + 1);
    a[0] = t0.x; a[1] = t0.y; a[2] = t1.x; a[3] = t1.y;
  }
  template <typename L>
  __device__ static double load_one(const double* p) { return L::ld(p); }
  __device__ static double x_in(double x) { return x; }
  __device__ static double madd(double a, double x, double acc) {
    return __dadd_rn(acc, __dmul_rn(a, x));
  }
};

template <>
struct Arith<__nv_bfloat16> {
  using Acc = float;
  // a bf16 is the high half of the fp32 with the same value
  template <typename L>
  __device__ static void load_group(const __nv_bfloat16* p, float a[kG]) {
    const uint2 t = L::ld(reinterpret_cast<const uint2*>(p));
    a[0] = __uint_as_float(t.x << 16);
    a[1] = __uint_as_float(t.x & 0xffff0000u);
    a[2] = __uint_as_float(t.y << 16);
    a[3] = __uint_as_float(t.y & 0xffff0000u);
  }
  template <typename L>
  __device__ static float load_one(const __nv_bfloat16* p) {
    const unsigned short b =
        L::ld(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(static_cast<unsigned int>(b) << 16);
  }
  __device__ static float x_in(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // a and xb hold bf16 values, so their fp32 product is exact and one
  // round-to-nearest-even to bf16 is the bf16 multiply
  __device__ static float madd(float a, float xb, float acc) {
    return __fadd_rn(acc, __bfloat162float(__float2bfloat16_rn(a * xb)));
  }
};

// lane's sum: acc[d] += vals[s] * x(cols[s])[d] over the lane's slots in
// slot order, for the slice starting at slot ``beg`` of width ``width``.
// ``x(c, out)`` writes the D components of x's row c.  The group loop
// reads values and columns four slots at a time (one 16-byte load per
// thread, through the load policy L) and is unrolled twice.
template <typename V, int D, typename X, typename L = Stream>
__device__ __forceinline__ void row_sum(const V* __restrict__ vals,
                                        const int* __restrict__ cols,
                                        int beg, int width, int lane,
                                        const X& x,
                                        typename Arith<V>::Acc acc[D]) {
  using A = Arith<V>;
  using T = typename A::Acc;
  const int n_grp = width / kG;
  const V* vp = vals + beg + lane * kG;
  const int* cp = cols + beg + lane * kG;
#pragma unroll 2
  for (int g = 0; g < n_grp; ++g) {
    T a[kG];
    A::template load_group<L>(vp + g * (kC * kG), a);
    const int4 c4 = L::ld(reinterpret_cast<const int4*>(cp + g * (kC * kG)));
    const int c[kG] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int t = 0; t < kG; ++t) {
      T xg[D];
      x(c[t], xg);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = A::madd(a[t], A::x_in(xg[d]), acc[d]);
    }
  }
  const int tail = beg + n_grp * (kC * kG) + lane;
  for (int r = 0; r < width - n_grp * kG; ++r) {
    const T a = A::template load_one<L>(vals + tail + r * kC);
    const int c = L::ld(cols + tail + r * kC);
    T xg[D];
    x(c, xg);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = A::madd(a, A::x_in(xg[d]), acc[d]);
  }
}

}  // namespace sell
