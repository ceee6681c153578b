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
// memory, over the flattened (tap, channel) axis.
//  * bf16 (every served and trained launch): the tensor-core tile of
//    conv_tc.cuh, wgmma m64n88k16: N = 81 padded to 88 (eleven n8 tiles),
//    the store masked to 81 and staged through shared memory, since 162-byte
//    output rows are not 16-byte aligned. The wrapper pads x to a multiple
//    of 8 channels (Cin 35 -> 40: one pass over x) and packs the weight as
//    [88][Kp] with K contiguous, the zero rows and columns included.
//  * f32 (the checks that need 1e-4 against the CPU; TF32 would not give
//    it): the SIMT tile of common.cuh, f32 FMA on the CUDA cores, 128
//    output voxels x all (padded) output channels per block (N = 81 padded
//    to 96), each A element read straight from x behind a bounds test.
// Both round alike: the f32 accumulator to the output dtype, then the bias
// added in f32 and rounded once.
#include "common.cuh"
#include "conv_tc.cuh"

namespace {

using namespace dpf;

constexpr int CO = 81;  // the offset heads' 3 x 27 channels, the only caller
constexpr int TN = 6;   // f32: 16 * TN = 96 >= CO; the store masks the rest
constexpr int N_TC = 88;  // bf16: eleven n8 tiles >= CO

__global__ void __launch_bounds__(NTHREADS)
conv3d_k3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wmat, const float* __restrict__ bias,
                     float* __restrict__ out, int B, int D, int H, int W, int C) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][16 * TN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = B * D * H * W;
  const int K = 27 * C;
  const int m0 = blockIdx.x * BM;

  // The voxels this thread loads (and accumulates): m0 + ty + 16*r.
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
  store_tile<float, TN>(out, bias, acc, m0, M, CO, tx, ty);
}

// bf16(bf16(acc) + bias[n]): store_tile's rounding, on the tensor-core tile.
struct BiasEpilogue {
  const __nv_bfloat16* bias;
  __device__ __forceinline__ __nv_bfloat16 operator()(float acc, int n) const {
    float v = __bfloat162float(__float2bfloat16_rn(acc));
    if (bias != nullptr) v = v + __bfloat162float(bias[n]);
    return __float2bfloat16_rn(v);
  }
};

}  // namespace

// f32 (is_bf16 0): x [B, D, H, W, C], wmat [27*C, CO] ((kd, kh, kw, c)
// rows). bf16 (is_bf16 1): x with C % 8 == 0, wmat the packed [88][Kp]
// (row n, column tap * C + c, Kp = 27 C rounded up to 64). bias [CO] or
// null, out [B, D, H, W, CO]; all contiguous, one dtype. Returns
// cudaErrorInvalidValue for Co != CO or a bf16 C % 8 != 0, else the launch's
// error.
extern "C" int dpf_conv3d_k3(const void* x, const void* wmat, const void* bias, void* out, int B,
                             int D, int H, int W, int C, int Co, int is_bf16, void* stream) {
  if (Co != CO) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (C % 8 != 0) return (int)cudaErrorInvalidValue;
    return dpf::tc::launch_conv3d_tc<N_TC>(x, wmat, out, BiasEpilogue{static_cast<const __nv_bfloat16*>(bias)}, B,
                                           D, H, W, C, CO, s);
  }
  const long long M = (long long)B * D * H * W;
  conv3d_k3_f32_kernel<<<(unsigned)((M + dpf::BM - 1) / dpf::BM), dpf::NTHREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wmat), static_cast<const float*>(bias),
      static_cast<float*>(out), B, D, H, W, C);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a bf16 block, in bytes (the build log shows
// only the static part).
extern "C" int dpf_conv3d_k3_smem_bytes() { return dpf::tc::smem_bytes(N_TC); }
