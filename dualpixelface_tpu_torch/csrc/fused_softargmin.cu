// K3: fused x4 align-corners trilinear upsample + soft-argmin.
//
// Replaces the TPU kernel `fused_softargmin` -> `_fsam` (`_kernel`;
// dualpixelface_tpu/ops/kernels/fused_softargmin.py:238, call at :181).
//   out[b, y, x] = sum_j softmax_j(logit_j) * dv[j],
//   logit_j = sum_{d, yy, xx} Wd[j, d] Wy[y, yy] Wx[x, xx] cost[b, d, yy, xx]
// computed in f32 and written in the input dtype. The full-resolution
// logit volume is never materialised.
//
// Bound on the H100: the exps. At the serving shape ([4, 8, 192, 144] ->
// 768 x 576, 32 bins) it moves ~5.3 MB in bf16 (1.6 us at 3.35 TB/s) and
// does ~0.42 GFLOP of f32 work (6.3 us at 67 TFLOP/s), but takes 56.6 M
// exps, one per bin and pixel, on the special-function units (16 per clock
// per SM: 13.5 us). Design (fsam.cuh): one thread per quad of 4 output
// pixels along x, which share 3 coarse columns, so each plane costs 6
// coarse loads per quad; the D operator's taps are compile-time constants
// (one instantiation per D), its weights and the bin values kernel
// parameters, the planes stay in registers; the softmax is stabilised by
// the max over the planes, so each bin takes one exp2 and the running
// rescales of an online softmax are gone (a pixel whose exps underflow is
// redone with the largest bin); the 4 outputs go out as one vector store.
// Any output height. D <= 16 compiles the taps in (one instantiation per
// D); above, `fsam_fwd_wide_kernel` takes D at run time (fsam.cuh).
#include <cstring>

#include "fsam.cuh"

namespace {

using namespace fsam;

constexpr int THREADS = 256;

template <typename T> struct Vec4;
template <> struct Vec4<float> {
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[4]) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&a);
    u.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// One pixel's disparity, sum_j e_j dv_j / sum_j e_j, from the quad's
// columns R and the pixel's weights u on them: the bins shifted by the max
// over the planes, or (EXACT) by the largest bin. `low` reports exps that
// summed below TINY (the result is then not used).
template <int D, bool EXACT>
__device__ __forceinline__ float pixel_disparity(const float (&R)[3][D], float4 u, const Bins& bn, bool& low) {
  float q[D];
  pixel_planes<D>(R, u, q);
  if (EXACT)
    shift_by_max_bin<D>(q, bn);
  else
    shift_by_planes<D>(q);
  float sum = 0.0f, num = 0.0f;
#pragma unroll
  for (int j = 0; j < FACTOR * D; ++j) {
    const float e = ex2(bin_logit<D>(q, bn, j));
    sum += e;
    num = fmaf(bn.dv[j], e, num);
  }
  low = sum < TINY;
  return num / sum;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fsam_fwd_kernel(const T* __restrict__ cost, T* __restrict__ out, int B, int h, int w,
                const int2* __restrict__ ytap, const float2* __restrict__ ywt,
                const float4* __restrict__ xu, const __grid_constant__ Bins bn) {
  const int Hp = FACTOR * h;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)B * Hp * w) return;
  const int q = (int)(t % w);
  const long long by = t / w;
  const int Y = (int)(by % Hp), b = (int)(by / Hp);

  const int2 yi = __ldg(ytap + Y);
  const float2 yw = __ldg(ywt + Y);
  const Quad qd(q, w);
  float R[3][D];
  rows_interp<T, D>(cost + (size_t)b * D * h * w, h, w, yi.x, yi.y, yw.x, yw.y, qd, R);

  float res[4];
  unsigned redo = 0;  // pixels whose exps underflowed: redone below, rarely
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bool low;
    res[k] = pixel_disparity<D, false>(R, __ldg(xu + 4 * q + k), bn, low);
    redo |= (unsigned)low << k;
  }
  T* o = out + ((size_t)b * Hp + Y) * (FACTOR * w) + 4 * q;
  Vec4<T>::store(o, res);
  if (redo) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      bool low;
      if (redo >> k & 1) o[k] = from_f32<T>(pixel_disparity<D, true>(R, __ldg(xu + 4 * q + k), bn, low));
    }
  }
}

template <typename T, int D>
int launch(const void* cost, void* out, int B, int h, int w, const int* ytap, const float* ywt, const float* xu,
           const Bins& bn, cudaStream_t s) {
  const long long n = (long long)B * FACTOR * h * w;
  fsam_fwd_kernel<T, D><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const T*>(cost), static_cast<T*>(out), B, h, w, reinterpret_cast<const int2*>(ytap),
      reinterpret_cast<const float2*>(ywt), reinterpret_cast<const float4*>(xu), bn);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* cost, void* out, int B, int h, int w, const int* ytap, const float* ywt,
             const float* xu, const Bins& bn, cudaStream_t s) {
  switch (D) {
#define FSAM_CASE(d) \
  case d:            \
    return launch<T, d>(cost, out, B, h, w, ytap, ywt, xu, bn, s);
    FSAM_CASE(1) FSAM_CASE(2) FSAM_CASE(3) FSAM_CASE(4) FSAM_CASE(5) FSAM_CASE(6) FSAM_CASE(7) FSAM_CASE(8)
    FSAM_CASE(9) FSAM_CASE(10) FSAM_CASE(11) FSAM_CASE(12) FSAM_CASE(13) FSAM_CASE(14) FSAM_CASE(15) FSAM_CASE(16)
#undef FSAM_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// D > MAXD: one thread per quad as above, each pixel through
// `wide_softmax` (the planes walked twice, the bins shifted by the largest).
template <typename T>
__global__ void __launch_bounds__(THREADS)
fsam_fwd_wide_kernel(const T* __restrict__ cost, T* __restrict__ out, int B, int D, int h, int w,
                     const int2* __restrict__ ytap, const float2* __restrict__ ywt, const float4* __restrict__ xu,
                     const float* __restrict__ bins) {
  const int Hp = FACTOR * h;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)B * Hp * w) return;
  const int q = (int)(t % w);
  const long long by = t / w;
  const int Y = (int)(by % Hp), b = (int)(by / Hp);
  const int2 yi = __ldg(ytap + Y);
  const float2 yw = __ldg(ywt + Y);
  WidePixel<T> px{cost + (size_t)b * D * h * w, (size_t)h * w, w, yi.x, yi.y, yw.x, yw.y, Quad(q, w),
                  make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
  float res[4];
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    px.u = __ldg(xu + 4 * q + k);
    float sum, num;
    wide_softmax<T>(px, bins, D, sum, num);
    res[k] = num / sum;
  }
  Vec4<T>::store(out + ((size_t)b * Hp + Y) * (FACTOR * w) + 4 * q, res);
}

}  // namespace

// D > 16 (any D): as `dpf_fused_softargmin`, the bin table on the device,
// f32 [5, 4D] (the rows of `Bins`, each 4D long). One launch; returns
// cudaGetLastError(), or cudaErrorInvalidValue for D <= 16.
extern "C" int dpf_fused_softargmin_wide(const void* cost, void* out, int B, int D, int h, int w, const int* ytap,
                                         const float* ywt, const float* xu, const float* bins, int is_bf16,
                                         void* stream) {
  if (D <= MAXD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)B * FACTOR * h * w;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  if (is_bf16)
    fsam_fwd_wide_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(cost), static_cast<__nv_bfloat16*>(out), B, D, h, w,
        reinterpret_cast<const int2*>(ytap), reinterpret_cast<const float2*>(ywt),
        reinterpret_cast<const float4*>(xu), bins);
  else
    fsam_fwd_wide_kernel<float><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(cost), static_cast<float*>(out), B, D, h, w, reinterpret_cast<const int2*>(ytap),
        reinterpret_cast<const float2*>(ywt), reinterpret_cast<const float4*>(xu), bins);
  return (int)cudaGetLastError();
}

// cost [B, D, h, w] (1 <= D <= 16), out [B, 4h, 4w]; one dtype (is_bf16
// selects bf16, else f32), on the device. ytap int32 [4h, 2] and ywt f32
// [4h, 2]: each output row's two coarse rows and weights; xu f32 [4w, 4]:
// each output column's weights on coarse columns q-1, q, q+1 of its quad
// q = x / 4 (and a 0); both on the device. bins: the host's f32 [5, 64]
// (`Bins`: per bin its lo and hi plane weights, its value and the weights
// times the value, taps as `tap_lo`/`tap_hi`), passed to the kernel by value. One launch; returns
// cudaGetLastError(), or cudaErrorInvalidValue for D outside 1..16.
extern "C" int dpf_fused_softargmin(const void* cost, void* out, int B, int D, int h, int w, const int* ytap,
                                    const float* ywt, const float* xu, const float* bins, int is_bf16,
                                    void* stream) {
  Bins bn;
  memcpy(&bn, bins, sizeof bn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(D, cost, out, B, h, w, ytap, ywt, xu, bn, s)
                 : dispatch<float>(D, cost, out, B, h, w, ytap, ywt, xu, bn, s);
}
