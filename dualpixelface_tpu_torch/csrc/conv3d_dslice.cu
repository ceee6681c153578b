// K5: dense 3x3x3 pad-1 stride-1 convolution, NDHWC, f32 or bf16 in,
// f32 accumulation, output in the input dtype (+ optional bias added in the
// output dtype).
//
// Replaces the TPU kernel `conv3d_dslice_pallas` -> `_conv3d_call` /
// `_kernel` (dualpixelface_tpu/ops/kernels/conv3d_dslice.py:207, call at
// :149), which runs the ANM deform offset heads (Cout = 81).
//
// Bound on the H100: operations. At the main-path shapes (serving, bf16:
// M = 442,368 voxels at batch 4, K = 27*Cin = 945 or 1728, N = 81) the
// product is 68-124 GFLOP against ~100-130 MB of bf16 traffic, far above
// the card's ~295 FLOP/byte ridge; the f32 route (the trainer's batch 4)
// does the same 191.6 GFLOP three times over as TF32, 575 GFLOP, 1.16 ms at
// 495 TFLOP/s, against 0.46 GB (0.14 ms).
// Design: an implicit GEMM that never writes the im2col matrix to device
// memory, over the flattened (tap, channel) axis, on the tensor-core tile
// of conv_tc.cuh: N = 81 padded to 88 (eleven n8 tiles), the store masked
// to 81 and staged through shared memory, since 81-element output rows are
// not 16-byte aligned. The wrapper pads x's channels and packs the weight
// as [88][Kp] with K contiguous, the zero rows and columns included.
//  * bf16 (serving and the bf16 train path): wgmma m64n88k16, x padded to a
//    multiple of 8 channels (Cin 35 -> 40).
//  * f32 (every committed run config trains in f32; the checks hold it to
//    1e-4 of the CPU): 3xTF32, wgmma m64n88k8 three times a k slice on
//    operands split into bit-masked TF32 halves (the weight split by the
//    wrapper into two planes, x split in registers), which keeps IEEE f32's
//    accuracy (TF32 alone would not); x padded to a multiple of 4 channels
//    (Cin 35 -> 36).
// Both round alike: the f32 accumulator to the output dtype, then the bias
// added in f32 and rounded once.
#include "conv_tc.cuh"

namespace {

constexpr int CO = 81;    // the offset heads' 3 x 27 channels, the only caller
constexpr int N_TC = 88;  // eleven n8 tiles >= CO

// bf16(bf16(acc) + bias[n]): the plain version's rounding.
struct BiasEpilogue {
  const __nv_bfloat16* bias;
  __device__ __forceinline__ __nv_bfloat16 operator()(float acc, int n) const {
    float v = __bfloat162float(__float2bfloat16_rn(acc));
    if (bias != nullptr) v = v + __bfloat162float(bias[n]);
    return __float2bfloat16_rn(v);
  }
};

// acc + bias[n] in f32.
struct F32BiasEpilogue {
  const float* bias;
  __device__ __forceinline__ float operator()(float acc, int n) const {
    return bias != nullptr ? acc + bias[n] : acc;
  }
};

}  // namespace

// x [B, D, H, W, C] (bf16: C % 8 == 0; f32: C % 4 == 0), wmat the packed
// weight: bf16 [88][Kp] (row n, column tap * C + c, Kp = 27 C rounded up to
// 64); f32 its two TF32 planes [2][88][Kp] (hi, lo; Kp rounded up to 32).
// bias [CO] or null, out [B, D, H, W, CO]; all contiguous, one dtype
// (is_bf16 1: bf16, 0: f32). Returns cudaErrorInvalidValue for Co != CO or
// C off its multiple, else the launch's error.
extern "C" int dpf_conv3d_k3(const void* x, const void* wmat, const void* bias, void* out, int B,
                             int D, int H, int W, int C, int Co, int is_bf16, void* stream) {
  if (Co != CO || C % (is_bf16 ? 8 : 4) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dpf::tc::launch_conv3d_tc<N_TC>(x, wmat, out, BiasEpilogue{static_cast<const __nv_bfloat16*>(bias)}, B,
                                           D, H, W, C, CO, s);
  return dpf::tc::launch_conv3d_3xtf32<N_TC>(x, wmat, out, F32BiasEpilogue{static_cast<const float*>(bias)}, B, D,
                                             H, W, C, CO, s);
}

// The dynamic shared memory of a block (bf16, f32), in bytes (the build
// log shows only the static part).
extern "C" int dpf_conv3d_k3_smem_bytes() { return dpf::tc::smem_bytes(N_TC); }
extern "C" int dpf_conv3d_k3_3xtf32_smem_bytes() { return dpf::tc::smem_bytes_3xtf32(N_TC); }
