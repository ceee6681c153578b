// Shared pieces of K3 (fused_softargmin.cu) and K4 (fused_softargmin_bwd.cu):
// the x4 align-corners upsample's D operator as compile-time taps, the bin
// weights and values as a kernel parameter, the interpolation of one output
// row's D coarse planes for a quad of 4 output pixels, and the softmax over
// the 4D bins with one exp each.
//
// A thread works on a quad: the 4 output pixels X = 4q..4q+3 of one output
// row Y. At x4 align-corners every tap of those pixels falls on coarse
// column q-1, q or q+1, so the quad reads 3 columns x 2 rows of each plane
// and weighs them with `xu[X]` (the pixel's weights on those 3 columns,
// built on the host; a column outside the volume gets weight 0 and a
// clamped address). Rows come from `ytap`/`ywt` (the two taps of row Y).
//
// The softmax takes one exp2 per bin, of the logit less a shift that no
// bin exceeds, in log2 units. K4 shifts by the largest bin, found among
// the few bins that can be largest (`shift_by_max_bin`). K3, which the
// exps bound, shifts by the max over the D interpolated planes, which
// every bin (a convex combination of at most two planes) is below: fewer
// operations (the largest-bin shift for every pixel made K3 12% slower on
// an H100, PERF.md), but planes far apart can leave every bin below it by
// more than f32's range; when the exps sum under TINY, K3 redoes the pixel
// with the largest bin.
#pragma once

#include <math.h>

#include "common.cuh"

namespace fsam {

using dpf::from_f32;
using dpf::to_f32;

constexpr int MAXD = 16;
constexpr int FACTOR = 4;
constexpr int MAXBINS = FACTOR * MAXD;
constexpr float LOG2E = 1.4426950408889634f;
// K3: a sum of exps below 2^-90 may have lost bins to f32's underflow
// (ftz): the pixel is redone with the largest bin (above it every bin
// within 2^-31 of the largest is a normal number)
constexpr float TINY = 8.077935669463161e-28f;

// The D operator's taps: bin j of the 4D sits at j (D-1) / (4D-1) between
// planes lo and hi (align corners), as `_linear_matrix` places it; the
// wrapper checks these against `_two_taps` and passes their weights.
template <int D> __host__ __device__ constexpr int tap_lo(int j) { return (j * (D - 1)) / (FACTOR * D - 1); }
template <int D> __host__ __device__ constexpr int tap_hi(int j) {
  return tap_lo<D>(j) + 1 < D ? tap_lo<D>(j) + 1 : D - 1;
}

// Per bin: the weights of its lo and hi planes, its value, and the two
// weights times the value (K4's sums take them as one FMA each); a kernel
// parameter (the constant bank), read at constant offsets.
struct Bins {
  float wa[MAXBINS];
  float wb[MAXBINS];
  float dv[MAXBINS];
  float wadv[MAXBINS];
  float wbdv[MAXBINS];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__device__ __forceinline__ float bin_logit(const float (&q)[D], const Bins& bn, int j) {
  return fmaf(bn.wb[j], q[tap_hi<D>(j)], bn.wa[j] * q[tap_lo<D>(j)]);
}

// q[d] = (P[d] - max_d P[d]) in log2 units: every bin's logit, so formed,
// is <= 0 and its exp2 <= 1.
template <int D>
__device__ __forceinline__ void shift_by_planes(float (&q)[D]) {
  float m = q[0];
#pragma unroll
  for (int d = 1; d < D; ++d) m = fmaxf(m, q[d]);
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = (q[d] - m) * LOG2E;
}

// q[d] = (P[d] - the largest bin's logit) in log2 units. A bin's logit is
// linear in its position between its two planes, so the largest lies at
// the first or last bin between some two planes (or on the last plane):
// only those bins, fixed at compile time, are evaluated. The largest bin's
// exp2 is then 1 (its weights sum to 1), so the sum cannot underflow.
template <int D>
__device__ __forceinline__ void shift_by_max_bin(float (&q)[D], const Bins& bn) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < FACTOR * D; ++j)
    if (j == 0 || j == FACTOR * D - 1 || tap_lo<D>(j) != tap_lo<D>(j - 1) || tap_lo<D>(j) != tap_lo<D>(j + 1))
      m = fmaxf(m, bin_logit<D>(q, bn, j));
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = (q[d] - m) * LOG2E;
}

// The quad's coarse reads: column indices q-1, q, q+1 clamped into the
// volume (their weights are 0 where clamped).
struct Quad {
  int c[3];
  __device__ __forceinline__ explicit Quad(int q, int w)
      : c{clamp(q - 1, w), clamp(q, w), clamp(q + 1, w)} {}
  static __device__ __forceinline__ int clamp(int c, int w) { return c < 0 ? 0 : (c < w ? c : w - 1); }
};

// R[c][d]: plane d interpolated along y at output row Y on column c of the
// quad (rows r0 and r1 of the coarse volume `cb` [D, h, w], weights y0, y1).
template <typename T, int D>
__device__ __forceinline__ void rows_interp(const T* __restrict__ cb, int h, int w, int r0, int r1, float y0,
                                            float y1, const Quad& qd, float (&R)[3][D]) {
  const size_t hw = (size_t)h * w;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const T* p0 = cb + d * hw + (size_t)r0 * w;
    const T* p1 = cb + d * hw + (size_t)r1 * w;
#pragma unroll
    for (int c = 0; c < 3; ++c) R[c][d] = fmaf(y1, to_f32(p1[qd.c[c]]), y0 * to_f32(p0[qd.c[c]]));
  }
}

// Pixel planes from the quad's columns: P[d] = sum_c u[c] R[c][d].
template <int D>
__device__ __forceinline__ void pixel_planes(const float (&R)[3][D], float4 u, float (&P)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) P[d] = fmaf(u.z, R[2][d], fmaf(u.y, R[1][d], u.x * R[0][d]));
}

// ----- more than MAXD planes (K3's and K4's wide kernels): D at run time.
// The planes no longer fit in registers, so a pixel walks them in order,
// one plane and the next at a time (the bins between planes d and d + 1
// are those with lo = d), and reads each again for every pass; the bin
// table is device memory, f32 [5][4D] as `Bins` lays out its rows, and the
// taps come from `wide_lo`, `tap_lo`'s formula at run time.

__device__ __forceinline__ int wide_lo(int j, int D) { return (j * (D - 1)) / (FACTOR * D - 1); }
// The first bin whose lo plane is d (D > 1).
__device__ __forceinline__ int wide_first_bin(int d, int D) { return (d * (FACTOR * D - 1) + D - 2) / (D - 1); }

// A pixel's coarse reads: rows r0 and r1 (weights y0, y1) of each plane of
// `cb` [D, h, w] on the quad's columns, weighed by u (rows_interp then
// pixel_planes, the same operations in the same order).
template <typename T>
struct WidePixel {
  const T* cb;
  size_t hw;
  int w, r0, r1;
  float y0, y1;
  Quad qd;
  float4 u;
  __device__ __forceinline__ float plane(int d) const {
    const T* p0 = cb + d * hw + (size_t)r0 * w;
    const T* p1 = cb + d * hw + (size_t)r1 * w;
    float R[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) R[c] = fmaf(y1, to_f32(p1[qd.c[c]]), y0 * to_f32(p0[qd.c[c]]));
    return fmaf(u.z, R[2], fmaf(u.y, R[1], u.x * R[0]));
  }
};

// The pixel's largest bin logit, and the sums of its exps shifted by it
// (sum, and num against the bin values): the largest bin's exp2 is 1, so
// the sum cannot underflow.
template <typename T>
__device__ __forceinline__ float wide_softmax(const WidePixel<T>& px, const float* __restrict__ bins, int D,
                                              float& sum, float& num) {
  const int nb = FACTOR * D;
  const float *wa = bins, *wb = bins + nb, *dv = bins + 2 * nb;
  float m = -INFINITY, plo = px.plane(0);
  int j = 0;
  for (int d = 0; d < D; ++d) {
    const float phi = d + 1 < D ? px.plane(d + 1) : plo;
    for (; j < nb && wide_lo(j, D) == d; ++j) m = fmaxf(m, fmaf(__ldg(wb + j), phi, __ldg(wa + j) * plo));
    plo = phi;
  }
  sum = 0.0f;
  num = 0.0f;
  plo = (px.plane(0) - m) * LOG2E;
  j = 0;
  for (int d = 0; d < D; ++d) {
    const float phi = d + 1 < D ? (px.plane(d + 1) - m) * LOG2E : plo;
    for (; j < nb && wide_lo(j, D) == d; ++j) {
      const float e = ex2(fmaf(__ldg(wb + j), phi, __ldg(wa + j) * plo));
      sum += e;
      num = fmaf(__ldg(dv + j), e, num);
    }
    plo = phi;
  }
  return m;
}

}  // namespace fsam
