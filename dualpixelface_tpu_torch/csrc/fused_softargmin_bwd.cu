// K4: backward of the fused x`factor` upsample + soft-argmin (K3).
//
// Replaces the TPU kernel `_fsam_bwd` (`_bwd_kernel`;
// dualpixelface_tpu/ops/kernels/fused_softargmin.py:198, call at :221).
// With p = softmax(logits) over the Dp upsampled bins of an output pixel and
// out = sum_j p_j dv_j, the cotangent of the logits is
//   glogit_j = g * p_j * (dv_j - out)
// and the cost gradient is U^T glogit for the separable align-corners
// operator U = Wd x Wy x Wx: dcost [B, D, h, w], accumulated in f32.
//
// Bound on the H100: f32 operations on the CUDA cores. At the train path's
// shape ([2, 8, 192, 144] -> 768 x 576) it moves ~5 MB in bf16 (cost and g
// read once, dcost written once) but recomputes K3's interpolation and
// softmax and adds the transposed interpolation, about twice K3's f32
// operations. Design: one thread per output pixel, a row of 128 pixels per
// block, as K3. Each thread recomputes its D interpolated coarse planes and
// the online softmax exactly as K3 does, then forms the glogits bin by bin,
// folds them back onto the D planes through the two D taps of each bin, and
// spreads each plane's gradient over the (at most) 2 x 2 coarse cells of its
// pixel. The block's pixels share one output row, so they touch at most two
// coarse rows and a short span of coarse columns: the spread goes into a
// shared-memory f32 tile with shared atomics, and the tile is then added to
// dcost with one global f32 atomicAdd per cell (a cell outside the span,
// which no align-corners x4 operator produces, goes straight to global
// memory). A last pass casts dcost to bf16 when the cost is bf16.
#include <math.h>

#include "common.cuh"

namespace {

using namespace dpf;

constexpr int MAXD = 16;
constexpr int ROW = 128;
constexpr int SPAN = 40;  // coarse columns one block's 128 pixels can touch (34 at x4)

template <typename T>
__global__ void __launch_bounds__(ROW)
fsam_bwd_kernel(const T* __restrict__ cost, const T* __restrict__ gout, float* __restrict__ dcost,
                int D, int h, int w, int Dp, int Hp, int Wp, const int* __restrict__ didx,
                const float* __restrict__ dwt, const int* __restrict__ yidx,
                const float* __restrict__ ywt, const int* __restrict__ xidx,
                const float* __restrict__ xwt, const float* __restrict__ dv) {
  __shared__ float planes[MAXD][ROW];
  __shared__ float tile[MAXD][2][SPAN];
  const int tid = threadIdx.x;
  const int X0 = blockIdx.x * ROW, X = X0 + tid;
  const int Y = blockIdx.y, b = blockIdx.z;
  const bool active = X < Wp;

  for (int e = tid; e < MAXD * 2 * SPAN; e += ROW) (&tile[0][0][0])[e] = 0.0f;

  const int y0 = yidx[2 * Y], y1 = yidx[2 * Y + 1];
  const float wy0 = ywt[2 * Y], wy1 = ywt[2 * Y + 1];
  const int base = xidx[2 * X0];  // the block's first coarse column
  int x0 = 0, x1 = 0;
  float wx0 = 0.0f, wx1 = 0.0f;
  float gd[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) gd[d] = 0.0f;

  if (active) {
    x0 = xidx[2 * X];
    x1 = xidx[2 * X + 1];
    wx0 = xwt[2 * X];
    wx1 = xwt[2 * X + 1];
    const T* cb = cost + (size_t)b * D * h * w;
    for (int d = 0; d < D; ++d) {
      const T* p = cb + (size_t)d * h * w;
      const float r0 = wx0 * to_f32(p[y0 * w + x0]) + wx1 * to_f32(p[y0 * w + x1]);
      const float r1 = wx0 * to_f32(p[y1 * w + x0]) + wx1 * to_f32(p[y1 * w + x1]);
      planes[d][tid] = wy0 * r0 + wy1 * r1;
    }

    // the forward's online softmax, then its final max, sum and output
    float mx = -INFINITY, sum = 0.0f, num = 0.0f;
    for (int j = 0; j < Dp; ++j) {
      const float l = dwt[2 * j] * planes[didx[2 * j]][tid] +
                      dwt[2 * j + 1] * planes[didx[2 * j + 1]][tid];
      const float mn = fmaxf(mx, l);
      const float scale = expf(mx - mn);
      const float e = expf(l - mn);
      sum = sum * scale + e;
      num = num * scale + dv[j] * e;
      mx = mn;
    }
    const float out = num / sum;
    const float ginv = to_f32(gout[((size_t)b * Hp + Y) * Wp + X]) / sum;

    // glogit_j, folded onto the coarse planes through the bin's two D taps
    for (int j = 0; j < Dp; ++j) {
      const int da = didx[2 * j], db = didx[2 * j + 1];
      const float wa = dwt[2 * j], wb = dwt[2 * j + 1];
      const float l = wa * planes[da][tid] + wb * planes[db][tid];
      const float gl = ginv * expf(l - mx) * (dv[j] - out);
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        if (d == da) gd[d] += wa * gl;
        if (d == db) gd[d] += wb * gl;
      }
    }
  }
  __syncthreads();

  if (active) {
    const int cx[2] = {x0, x1};
    const float wxs[2] = {wx0, wx1};
    const float wys[2] = {wy0, wy1};
    const int rows[2] = {y0, y1};
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {  // static bound: gd stays in registers
      if (d >= D) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (wys[r] == 0.0f) continue;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (wxs[k] == 0.0f) continue;
          const float v = gd[d] * wys[r] * wxs[k];
          const int col = cx[k] - base;
          if (col >= 0 && col < SPAN)
            atomicAdd(&tile[d][r][col], v);
          else
            atomicAdd(&dcost[(((size_t)b * D + d) * h + rows[r]) * w + cx[k]], v);
        }
      }
    }
  }
  __syncthreads();

  // flush the tile: one global atomic per touched coarse cell
  for (int e = tid; e < D * 2 * SPAN; e += ROW) {
    const int d = e / (2 * SPAN), r = (e / SPAN) % 2, col = e % SPAN;
    const float v = tile[d][r][col];
    const int xc = base + col;
    if (v != 0.0f && xc < w) {
      const int yc = r ? y1 : y0;
      atomicAdd(&dcost[(((size_t)b * D + d) * h + yc) * w + xc], v);
    }
  }
}

}  // namespace

// cost [B, D, h, w] (D <= 16) and gout [B, Hp, Wp] in one dtype (is_bf16
// selects bf16, else f32); dcost32 f32 [B, D, h, w] scratch (zeroed here);
// dcost the output in the cost's dtype (for f32 pass dcost32 itself). The
// tap tables as for K3 (`dpf_fused_softargmin`). Returns
// cudaErrorInvalidValue for D > 16, else the first launch error.
extern "C" int dpf_fused_softargmin_bwd(const void* cost, const void* gout, float* dcost32,
                                        void* dcost, int B, int D, int h, int w, int Dp, int Hp,
                                        int Wp, const int* didx, const float* dwt,
                                        const int* yidx, const float* ywt, const int* xidx,
                                        const float* xwt, const float* dv, int is_bf16,
                                        void* stream) {
  if (D > MAXD || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)B * D * h * w;
  int rc = (int)cudaMemsetAsync(dcost32, 0, (size_t)n * sizeof(float), s);
  if (rc != 0) return rc;
  dim3 grid((unsigned)((Wp + ROW - 1) / ROW), (unsigned)Hp, (unsigned)B);
  if (is_bf16)
    fsam_bwd_kernel<__nv_bfloat16><<<grid, ROW, 0, s>>>(
        static_cast<const __nv_bfloat16*>(cost), static_cast<const __nv_bfloat16*>(gout), dcost32, D,
        h, w, Dp, Hp, Wp, didx, dwt, yidx, ywt, xidx, xwt, dv);
  else
    fsam_bwd_kernel<float><<<grid, ROW, 0, s>>>(static_cast<const float*>(cost),
                                                 static_cast<const float*>(gout), dcost32, D, h, w,
                                                 Dp, Hp, Wp, didx, dwt, yidx, ywt, xidx, xwt, dv);
  rc = (int)cudaGetLastError();
  if (rc != 0 || !is_bf16) return rc;
  return dpf::cast_bf16(dcost32, dcost, n, s);
}
