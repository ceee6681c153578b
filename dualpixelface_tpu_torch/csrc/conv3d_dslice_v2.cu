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
// Design: K5's implicit GEMM over the flattened (tap, channel) axis, one
// block per 128 output voxels and all Co output channels, with the epilogue
// in registers, so the BatchNorm and ReLU cost no pass over device memory.
//  * bf16 (every timed launch): the tensor-core tile of conv_tc.cuh, wgmma
//    m64n32k16 / m64n64k16, N = Co; the wrapper pads x to a multiple of 8
//    channels and packs the weight as [Co][Kp] with K contiguous.
//  * f32: the SIMT tile of common.cuh (conv_voxels, load_conv_a_tile,
//    load_b_tile, mma_tile), f32 FMA on the CUDA cores, which keeps the f32
//    checks at 1e-4 (TF32 would not).
#include "common.cuh"
#include "conv_tc.cuh"

namespace {

using namespace dpf;

template <int TN>
__global__ void __launch_bounds__(NTHREADS)
conv3d_affine_f32_kernel(const float* __restrict__ x, const float* __restrict__ wmat, const float* __restrict__ ab,
                         float* __restrict__ out, int B, int D, int H, int W, int C, int relu) {
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
    load_conv_a_tile<float>(As, x, vm, vd, vh, vw, k0, M, D, H, W, C, tx, ty);
    load_b_tile<float, TN>(Bs, wmat, k0, min(BK, K - k0), CO, tid);
    __syncthreads();
    mma_tile<TN>(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  // epilogue: acc * a + b (two f32 roundings, not an FMA, as the plain
  // version computes it), then ReLU
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
      out[(size_t)m * CO + tx + 16 * j] = v;
    }
  }
}

// The same epilogue on the tensor-core tile, then the one rounding to bf16.
struct AffineEpilogue {
  const float* ab;  // [2][co] or null
  int co, relu;
  __device__ __forceinline__ __nv_bfloat16 operator()(float acc, int n) const {
    float v = acc;
    if (ab != nullptr) v = __fadd_rn(__fmul_rn(v, ab[n]), ab[co + n]);
    if (relu) v = fmaxf(v, 0.0f);
    return __float2bfloat16_rn(v);
  }
};

template <int TN>
void launch_f32(cudaStream_t s, const void* x, const void* w, const float* ab, void* out, int B, int D, int H, int W,
                int C, int relu) {
  const long long M = (long long)B * D * H * W;
  conv3d_affine_f32_kernel<TN><<<(unsigned)((M + BM - 1) / BM), NTHREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), ab, static_cast<float*>(out), B, D, H, W, C, relu);
}

}  // namespace

// f32 (is_bf16 0): x [B, D, H, W, C], wmat [27*C, Co] ((kd, kh, kw, c)
// rows). bf16 (is_bf16 1): x with C % 8 == 0, wmat the packed [Co][Kp] (row
// n, column tap * C + c, Kp = 27 C rounded up to 64). ab [2, Co] f32 (a then
// b) or null; out [B, D, H, W, Co]; all contiguous. Returns
// cudaErrorInvalidValue for Co other than 32 or 64 or a bf16 C % 8 != 0,
// else the launch's error.
extern "C" int dpf_conv3d_k3_affine(const void* x, const void* wmat, const void* ab, void* out, int B, int D,
                                    int H, int W, int C, int Co, int relu, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* abf = static_cast<const float*>(ab);
  if (Co != 32 && Co != 64) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (C % 8 != 0) return (int)cudaErrorInvalidValue;
    const AffineEpilogue epi{abf, Co, relu};
    if (Co == 32) return dpf::tc::launch_conv3d_tc<32>(x, wmat, out, epi, B, D, H, W, C, Co, s);
    return dpf::tc::launch_conv3d_tc<64>(x, wmat, out, epi, B, D, H, W, C, Co, s);
  }
  if (Co == 32)
    launch_f32<2>(s, x, wmat, abf, out, B, D, H, W, C, relu);
  else
    launch_f32<4>(s, x, wmat, abf, out, B, D, H, W, C, relu);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a bf16 block for Co output channels, in
// bytes (the build log shows only the static part).
extern "C" int dpf_conv3d_k3_affine_smem_bytes(int Co) { return dpf::tc::smem_bytes(Co); }
