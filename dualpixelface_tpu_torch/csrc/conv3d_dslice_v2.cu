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
// Bound on the H100: operations on the tensor cores. At the four sites of
// the tool (batch 4 at 768x576) the product is 174.3 GFLOP: in bf16 0.176
// ms at 989 TFLOP/s; in f32, three TF32 passes at 495 TFLOP/s, 1.06 ms,
// against about 0.63 GB (0.19 ms). On the CUDA cores the f32 work could
// not take less than 2.6 ms.
// Design: K5's implicit GEMM over the flattened (tap, channel) axis
// (conv_tc.cuh), one block per 128 output voxels and all Co output
// channels, with the epilogue in registers, so the BatchNorm and ReLU cost
// no pass over device memory. The wrapper pads x's channels and packs the
// weight as [Co][Kp] with K contiguous.
//  * bf16: wgmma m64n32k16 / m64n64k16, x padded to a multiple of 8
//    channels (`pack_conv3d`).
//  * f32: split-TF32 (3xTF32), wgmma m64n32k8 / m64n64k8 three times a k
//    slice on operands split into bit-masked TF32 halves (the weight's two
//    planes [2][Co][Kp] from the wrapper, `pack_conv3d_3xtf32`; x split in
//    registers as wgmma's register A), which keeps the f32 checks at 1e-4
//    (one TF32 pass would not). x padded to a multiple of 4 channels. At Co
//    32 each split A fragment feeds a third of K5's N, so the fragments'
//    loads and splits weigh more against the MMAs than in K5; but the
//    gather's instruction stream sets the pace (`tools.bench_t1_split`:
//    without the products the kernel keeps about 60% of its time), so the
//    Co 32 instantiation runs three blocks an SM to hide more of it.
#include "conv_tc.cuh"

namespace {

// acc * a + b (two f32 roundings, not an FMA, as the plain version
// computes it), then the ReLU.
__device__ __forceinline__ float affine_relu(float acc, const float* ab, int co, int relu, int n) {
  float v = acc;
  if (ab != nullptr) v = __fadd_rn(__fmul_rn(v, ab[n]), ab[co + n]);
  if (relu) v = fmaxf(v, 0.0f);
  return v;
}

// The epilogue on the bf16 route: then the one rounding to bf16.
struct AffineEpilogue {
  const float* ab;  // [2][co] or null
  int co, relu;
  __device__ __forceinline__ __nv_bfloat16 operator()(float acc, int n) const {
    return __float2bfloat16_rn(affine_relu(acc, ab, co, relu, n));
  }
};

// The epilogue on the f32 route, stored as it is.
struct F32AffineEpilogue {
  const float* ab;  // [2][co] or null
  int co, relu;
  __device__ __forceinline__ float operator()(float acc, int n) const { return affine_relu(acc, ab, co, relu, n); }
};

}  // namespace

// x [B, D, H, W, C], wmat the packed weight: bf16 (is_bf16 1) [Co][Kp]
// (row n, column tap * C + c, Kp = 27 C rounded up to 64), C % 8 == 0; f32
// (is_bf16 0) its two TF32 planes [2][Co][Kp] (hi, lo; Kp rounded up to
// 32), C % 4 == 0. ab [2, Co] f32 (a then b) or null; out [B, D, H, W, Co]
// in x's dtype; all contiguous. Returns cudaErrorInvalidValue for Co other
// than 32 or 64 or C off its multiple, else the launch's error.
extern "C" int dpf_conv3d_k3_affine(const void* x, const void* wmat, const void* ab, void* out, int B, int D,
                                    int H, int W, int C, int Co, int relu, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* abf = static_cast<const float*>(ab);
  if ((Co != 32 && Co != 64) || C % (is_bf16 ? 8 : 4) != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const AffineEpilogue epi{abf, Co, relu};
    if (Co == 32) return dpf::tc::launch_conv3d_tc<32>(x, wmat, out, epi, B, D, H, W, C, Co, s);
    return dpf::tc::launch_conv3d_tc<64>(x, wmat, out, epi, B, D, H, W, C, Co, s);
  }
  const F32AffineEpilogue epi{abf, Co, relu};
  if (Co == 32) return dpf::tc::launch_conv3d_3xtf32<32>(x, wmat, out, epi, B, D, H, W, C, Co, s);
  return dpf::tc::launch_conv3d_3xtf32<64>(x, wmat, out, epi, B, D, H, W, C, Co, s);
}

// The dynamic shared memory of a block for Co output channels (bf16, f32),
// in bytes (the build log shows only the static part).
extern "C" int dpf_conv3d_k3_affine_smem_bytes(int Co) { return dpf::tc::smem_bytes(Co); }
extern "C" int dpf_conv3d_k3_affine_3xtf32_smem_bytes(int Co) { return dpf::tc::smem_bytes_3xtf32(Co); }
