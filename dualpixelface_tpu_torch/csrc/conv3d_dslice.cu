// K5: dense 3x3x3 pad-1 stride-1 convolution, NDHWC, f32 or bf16 in,
// f32 accumulation, output in the input dtype (+ optional bias added in the
// output dtype).
//
// Replaces the TPU kernel `conv3d_dslice_pallas` -> `_conv3d_call` /
// `_kernel` (dualpixelface_tpu/ops/kernels/conv3d_dslice.py:207, call at
// :149), which runs the ANM deform offset heads (Cout = 81).
//
// Bound on the H100: operations. At the main-path shape (M = 442,368
// voxels, K = 27*Cin = 945 or 1728, N = 81) the product is 68-124 GFLOP
// against ~100-130 MB of bf16 traffic, far above the card's ~295 FLOP/byte
// ridge.
// Design: an implicit GEMM that never writes the im2col matrix to device
// memory. Each block owns 128 output voxels x all (padded) output channels
// (N = 81 padded to 96 and masked at the store); the reduction runs over the
// flattened (tap, channel) axis, so Cin = 35 wastes no padded slice. Each
// A-tile element is read straight from x with the zero padding applied by a
// bounds test. f32 FMA on the CUDA cores; a tensor-core (wgmma) version is
// later work.
#include "common.cuh"

namespace {

using namespace dpf;

constexpr int CO = 81;  // the offset heads' 3 x 27 channels, the only caller
constexpr int TN = 6;   // 16 * TN = 96 >= CO; the store masks the rest

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
conv3d_k3_kernel(const T* __restrict__ x, const T* __restrict__ wmat, const T* __restrict__ bias,
                 T* __restrict__ out, int B, int D, int H, int W, int C) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][16 * TN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = B * D * H * W;
  const int K = 27 * C;
  const int m0 = blockIdx.x * BM;

  // The voxels this thread loads (and accumulates): m0 + ty + 16*r.
  int vm[TM], vd[TM], vh[TM], vw[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + ty + 16 * r;
    vm[r] = m;
    int t = m;
    vw[r] = t % W; t /= W;
    vh[r] = t % H; t /= H;
    vd[r] = t % D;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + tx;
    const int tap = k / C, c = k - tap * C;
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    const int shift = ((kd - 1) * H + (kh - 1)) * W + (kw - 1);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float v = 0.0f;
      const int dd = vd[r] + kd - 1, hh = vh[r] + kh - 1, ww = vw[r] + kw - 1;
      if (k < K && vm[r] < M && dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = to_f32(x[(size_t)(vm[r] + shift) * C + c]);
      As[tx][ty + 16 * r] = v;
    }
    load_b_tile<T, TN>(Bs, wmat, k0, min(BK, K - k0), CO, tid);
    __syncthreads();
    mma_tile<TN>(As, Bs, acc, tx, ty);
    __syncthreads();
  }
  store_tile<T, TN>(out, bias, acc, m0, M, CO, tx, ty);
}

template <typename T>
void launch(dim3 grid, cudaStream_t s, const void* x, const void* w, const void* bias, void* out,
            int B, int D, int H, int W, int C) {
  conv3d_k3_kernel<T><<<grid, NTHREADS, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                static_cast<const T*>(bias), static_cast<T*>(out),
                                                B, D, H, W, C);
}

}  // namespace

// x [B, D, H, W, C], wmat [27*C, CO] ((kd, kh, kw, c) rows), bias [CO] or
// null, out [B, D, H, W, CO]; all contiguous, one dtype (is_bf16 selects
// bf16, else f32). Returns cudaErrorInvalidValue for Co != CO, else
// cudaGetLastError() after the launch.
extern "C" int dpf_conv3d_k3(const void* x, const void* wmat, const void* bias, void* out, int B,
                             int D, int H, int W, int C, int Co, int is_bf16, void* stream) {
  if (Co != CO) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * D * H * W;
  dim3 grid((unsigned)((M + dpf::BM - 1) / dpf::BM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(grid, s, x, wmat, bias, out, B, D, H, W, C);
  else
    launch<float>(grid, s, x, wmat, bias, out, B, D, H, W, C);
  return (int)cudaGetLastError();
}
