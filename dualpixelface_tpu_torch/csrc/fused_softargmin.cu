// K3: fused x`factor` align-corners trilinear upsample + soft-argmin.
//
// Replaces the TPU kernel `fused_softargmin` -> `_fsam` (`_kernel`;
// dualpixelface_tpu/ops/kernels/fused_softargmin.py:238, call at :181).
//   out[b, y, x] = sum_j softmax_j(logit_j) * dv[j],
//   logit_j = sum_{d, yy, xx} Wd[j, d] Wy[y, yy] Wx[x, xx] cost[b, d, yy, xx]
// computed in f32 and written in the input dtype. The full-resolution
// logit volume is never materialised.
//
// Bound on the H100: f32 operations on the CUDA cores. At the main-path
// shape it moves ~5.3 MB in bf16 (coarse volume read once, one value per
// output pixel written; 1.6 us at 3.35 TB/s) but does ~0.6 GFLOP of f32
// interpolation, exp and softmax updates (32 bins per pixel; ~9.5 us at
// 67 TFLOP/s). Design: one thread per output pixel, a row of 128 pixels per
// block. Each 1-D operator row of the align-corners matrices (built on the
// host by `_linear_matrix`) has at most two non-zeros, passed as (index,
// weight) pairs; the thread interpolates each coarse plane from its 2x2
// neighbours (x, then y), keeps the D interpolated values in shared memory,
// and runs an online softmax (running max, sum and weighted sum) over the
// upsampled bins. Neighbouring threads share their coarse reads in L1.
// No constraint on the output height (the TPU kernel needed 4h % 32 == 0).
#include <math.h>

#include "common.cuh"

namespace {

using namespace dpf;

constexpr int MAXD = 16;
constexpr int ROW = 128;

template <typename T>
__global__ void __launch_bounds__(ROW)
fused_softargmin_kernel(const T* __restrict__ cost, T* __restrict__ out, int D, int h, int w,
                        int Dp, int Hp, int Wp, const int* __restrict__ didx,
                        const float* __restrict__ dwt, const int* __restrict__ yidx,
                        const float* __restrict__ ywt, const int* __restrict__ xidx,
                        const float* __restrict__ xwt, const float* __restrict__ dv) {
  __shared__ float planes[MAXD][ROW];
  const int X = blockIdx.x * ROW + threadIdx.x;
  const int Y = blockIdx.y, b = blockIdx.z;
  if (X >= Wp) return;

  const int y0 = yidx[2 * Y], y1 = yidx[2 * Y + 1];
  const float wy0 = ywt[2 * Y], wy1 = ywt[2 * Y + 1];
  const int x0 = xidx[2 * X], x1 = xidx[2 * X + 1];
  const float wx0 = xwt[2 * X], wx1 = xwt[2 * X + 1];
  const T* cb = cost + (size_t)b * D * h * w;
  for (int d = 0; d < D; ++d) {
    const T* p = cb + (size_t)d * h * w;
    const float r0 = wx0 * to_f32(p[y0 * w + x0]) + wx1 * to_f32(p[y0 * w + x1]);
    const float r1 = wx0 * to_f32(p[y1 * w + x0]) + wx1 * to_f32(p[y1 * w + x1]);
    planes[d][threadIdx.x] = wy0 * r0 + wy1 * r1;
  }

  float mx = -INFINITY, sum = 0.0f, num = 0.0f;
  for (int j = 0; j < Dp; ++j) {
    const float l = dwt[2 * j] * planes[didx[2 * j]][threadIdx.x] +
                    dwt[2 * j + 1] * planes[didx[2 * j + 1]][threadIdx.x];
    const float mn = fmaxf(mx, l);
    const float scale = expf(mx - mn);
    const float e = expf(l - mn);
    sum = sum * scale + e;
    num = num * scale + dv[j] * e;
    mx = mn;
  }
  out[((size_t)b * Hp + Y) * Wp + X] = from_f32<T>(num / sum);
}

}  // namespace

// cost [B, D, h, w] (D <= 16), out [B, Hp, Wp]; one dtype (is_bf16 selects
// bf16, else f32). didx/dwt [Dp, 2], yidx/ywt [Hp, 2], xidx/xwt [Wp, 2]:
// the two (index, weight) taps of each interpolation-operator row (weight 0
// where a row has one tap); dv [Dp] the bin values. All on the device.
// Returns cudaGetLastError().
extern "C" int dpf_fused_softargmin(const void* cost, void* out, int B, int D, int h, int w,
                                    int Dp, int Hp, int Wp, const int* didx, const float* dwt,
                                    const int* yidx, const float* ywt, const int* xidx,
                                    const float* xwt, const float* dv, int is_bf16,
                                    void* stream) {
  if (D > MAXD) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((Wp + ROW - 1) / ROW), (unsigned)Hp, (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    fused_softargmin_kernel<__nv_bfloat16><<<grid, ROW, 0, s>>>(
        static_cast<const __nv_bfloat16*>(cost), static_cast<__nv_bfloat16*>(out), D, h, w, Dp, Hp,
        Wp, didx, dwt, yidx, ywt, xidx, xwt, dv);
  else
    fused_softargmin_kernel<float><<<grid, ROW, 0, s>>>(
        static_cast<const float*>(cost), static_cast<float*>(out), D, h, w, Dp, Hp, Wp, didx, dwt,
        yidx, ywt, xidx, xwt, dv);
  return (int)cudaGetLastError();
}
