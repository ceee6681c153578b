// T1: dense 3x3x3 pad-1 stride-1 convolution, NDHWC, with a per-channel
// affine epilogue (the eval BatchNorm folded to a * y + b) and an optional
// ReLU, applied to the f32 accumulator before the one rounding to the
// input dtype. f32 or bf16 in, f32 accumulation.
//
// Replaces the TPU kernel `conv3d_dslice_v2` -> `_conv3d_call_v2` /
// `_kernel_v2` (tools/attic/conv3d_dslice_v2.py:139, call at :95, body
// :26-63): the hourglass's stride-1 ConvBN3D(+ReLU) sites, Co 32 and 64.
// The TPU kernel's kw lane fold is a TPU layout and is not carried over.
//
// Bound on the H100: operations on the tensor cores. At the `dres*` site
// (32 -> 32 on [4, 8, 192, 144], bf16) the product is 48.9 GFLOP (0.049 ms
// at 989 TFLOP/s) against 113 MB (0.034 ms); on the CUDA cores in f32 the
// same work cannot take less than 0.73 ms.
// Design: K5's implicit GEMM over the flattened (tap, channel) axis
// (common.cuh: conv_voxels, load_conv_a_tile, load_b_tile, mma_tile), one
// block per 128 output voxels and all Co = 16 * TN output channels, with
// the epilogue in registers, so the BatchNorm and ReLU cost no pass over
// device memory. f32 FMA on the CUDA cores; a tensor-core (wgmma) version
// is later work.
#include "common.cuh"

namespace {

using namespace dpf;

template <typename T, int TN>
__global__ void __launch_bounds__(NTHREADS)
conv3d_affine_kernel(const T* __restrict__ x, const T* __restrict__ wmat, const float* __restrict__ ab,
                     T* __restrict__ out, int B, int D, int H, int W, int C, int relu) {
  constexpr int CO = 16 * TN;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][CO];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = B * D * H * W;
  const int K = 27 * C;
  const int m0 = blockIdx.x * BM;

  int vm[TM], vd[TM], vh[TM], vw[TM];
  conv_voxels(m0 + ty, D, H, W, vm, vd, vh, vw);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_conv_a_tile<T>(As, x, vm, vd, vh, vw, k0, M, D, H, W, C, tx, ty);
    load_b_tile<T, TN>(Bs, wmat, k0, min(BK, K - k0), CO, tid);
    __syncthreads();
    mma_tile<TN>(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  // epilogue: acc * a + b (two f32 roundings, not an FMA, as the plain
  // version computes it), then ReLU, then the one rounding to T
  float ea[TN], eb[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    ea[j] = ab != nullptr ? ab[tx + 16 * j] : 1.0f;
    eb[j] = ab != nullptr ? ab[CO + tx + 16 * j] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float v = acc[i][j];
      if (ab != nullptr) v = __fadd_rn(__fmul_rn(v, ea[j]), eb[j]);
      if (relu) v = fmaxf(v, 0.0f);
      out[(size_t)m * CO + tx + 16 * j] = from_f32<T>(v);
    }
  }
}

template <typename T, int TN>
void launch(dim3 grid, cudaStream_t s, const void* x, const void* w, const float* ab, void* out, int B,
            int D, int H, int W, int C, int relu) {
  conv3d_affine_kernel<T, TN><<<grid, NTHREADS, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                        ab, static_cast<T*>(out), B, D, H, W, C, relu);
}

template <typename T>
int dispatch(dim3 grid, cudaStream_t s, const void* x, const void* w, const float* ab, void* out, int B,
             int D, int H, int W, int C, int Co, int relu) {
  if (Co == 32)
    launch<T, 2>(grid, s, x, w, ab, out, B, D, H, W, C, relu);
  else if (Co == 64)
    launch<T, 4>(grid, s, x, w, ab, out, B, D, H, W, C, relu);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, D, H, W, C], wmat [27*C, Co] ((kd, kh, kw, c) rows), one dtype
// (is_bf16 selects bf16, else f32); ab [2, Co] f32 (a then b) or null; out
// [B, D, H, W, Co]; all contiguous. Returns cudaErrorInvalidValue for Co
// other than 32 or 64, else cudaGetLastError() after the launch.
extern "C" int dpf_conv3d_k3_affine(const void* x, const void* wmat, const void* ab, void* out, int B, int D,
                                    int H, int W, int C, int Co, int relu, int is_bf16, void* stream) {
  const long long M = (long long)B * D * H * W;
  dim3 grid((unsigned)((M + dpf::BM - 1) / dpf::BM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* abf = static_cast<const float*>(ab);
  if (is_bf16) return dispatch<__nv_bfloat16>(grid, s, x, wmat, abf, out, B, D, H, W, C, Co, relu);
  return dispatch<float>(grid, s, x, wmat, abf, out, B, D, H, W, C, Co, relu);
}
