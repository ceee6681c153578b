// K1: deformable 3x3x3 convolution, stride 1, pad 1, NDHWC, f32 or bf16.
//
// Replaces the TPU kernel `deform_conv3d_fused` -> `_fused_call` (`_kernel`
// v5; dualpixelface_tpu/ops/kernels/deform_fused.py:598, call at :557).
// Semantics (the JAX package's `_deform_conv3d_packed`): for output voxel
// (d, h, w) and tap (kd, kh, kw), the sampling position is
//   (d - 1 + kd + dD, h - 1 + kh + dH, w - 1 + kw + dW)
// with the offsets read as f32; with `aperture` set, the H and W positions
// are clamped to [out - 3, out + 4 - 1/1024] (the windowed semantics of the
// TPU kernel), D never. Each position is sampled trilinearly, a corner
// outside the volume contributing zero. The samples (27 taps x Cin) are
// contracted against the weight [27*Cin, Cout] with f32 accumulation; the
// output is rounded to the input dtype and the bias added in that dtype.
//
// Bound on the H100: operations (98 GFLOP at the Cin = 64 main-path shape,
// 0.10 ms at 989 TFLOP/s bf16, against ~185 MB in bf16 that must move,
// 0.055 ms at 3.35 TB/s). The TPU kernel expressed the gather as
// one-hot matmuls over a +-3 window because its vector unit has no cheap
// gather; here the gather is a plain load, so no window limits it and one
// kernel serves both semantics. Design: a block owns 128 output voxels x
// Cout; per tap it computes the 8 corner indices and weights of its voxels
// once into shared memory, then builds the A tile (16 channels x 128
// voxels) by weighted corner loads -- consecutive threads read consecutive
// channels of one corner, so loads coalesce -- rounds each sample to the
// input dtype, and runs the shared SIMT GEMM tile. The im2col matrix never
// touches device memory. f32 FMA on the CUDA cores (67 TFLOP/s) caps the
// contraction well below the bound; a tensor-core version is later work.
#include "common.cuh"

namespace {

using namespace dpf;

constexpr float EPS = 1.0f / 1024.0f;
constexpr float AP = 3.0f;
constexpr int CO = 64;  // the ANM deform convs' output channels, the only caller
constexpr int TN = 4;   // 16 * TN = CO: one block covers every output channel

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
deform_conv3d_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                     const T* __restrict__ wmat, const T* __restrict__ bias, T* __restrict__ out,
                     int B, int D, int H, int W, int C, int aperture) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][16 * TN];
  __shared__ int cidx[8][BM];   // corner voxel index, -1 when outside
  __shared__ float cwt[8][BM];  // corner weight
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = B * D * H * W;
  const int m0 = blockIdx.x * BM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int tap = 0; tap < 27; ++tap) {
    if (tid < BM) {
      const int m = m0 + tid;
      if (m < M) {
        int t = m;
        const int w = t % W; t /= W;
        const int h = t % H; t /= H;
        const int d = t % D;
        const int b = t / D;
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        const T* op = offset + (size_t)m * 81 + tap * 3;
        const float pd = (float)(d - 1 + kd) + to_f32(op[0]);
        float ph = (float)(h - 1 + kh) + to_f32(op[1]);
        float pw = (float)(w - 1 + kw) + to_f32(op[2]);
        if (aperture) {
          ph = fminf(fmaxf(ph, (float)h - AP), (float)h + AP + 1.0f - EPS);
          pw = fminf(fmaxf(pw, (float)w - AP), (float)w + AP + 1.0f - EPS);
        }
        const float d0 = floorf(pd), h0 = floorf(ph), w0 = floorf(pw);
        const float fd = pd - d0, fh = ph - h0, fw = pw - w0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int cz = q >> 2, cy = (q >> 1) & 1, cx = q & 1;
          const float zi = d0 + cz, yi = h0 + cy, xi = w0 + cx;
          const bool ok = zi >= 0.0f && zi <= (float)(D - 1) && yi >= 0.0f &&
                          yi <= (float)(H - 1) && xi >= 0.0f && xi <= (float)(W - 1);
          const float wz = cz ? fd : 1.0f - fd;
          const float wy = cy ? fh : 1.0f - fh;
          const float wx = cx ? fw : 1.0f - fw;
          cidx[q][tid] = ok ? ((b * D + (int)zi) * H + (int)yi) * W + (int)xi : -1;
          cwt[q][tid] = ok ? (wz * wy) * wx : 0.0f;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          cidx[q][tid] = -1;
          cwt[q][tid] = 0.0f;
        }
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += BK) {
      const int c = c0 + tx;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int ml = ty + 16 * r;
        float s = 0.0f;
        if (c < C) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int id = cidx[q][ml];
            if (id >= 0) s += cwt[q][ml] * to_f32(x[(size_t)id * C + c]);
          }
        }
        As[tx][ml] = round_to<T>(s);
      }
      load_b_tile<T, TN>(Bs, wmat, tap * C + c0, min(BK, C - c0), CO, tid);
      __syncthreads();
      mma_tile<TN>(As, Bs, acc, tx, ty);
      __syncthreads();
    }
  }
  store_tile<T, TN>(out, bias, acc, m0, M, CO, tx, ty);
}

template <typename T>
void launch(dim3 grid, cudaStream_t s, const void* x, const void* offset, const void* w,
            const void* bias, void* out, int B, int D, int H, int W, int C, int aperture) {
  deform_conv3d_kernel<T><<<grid, NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), B, D, H, W, C, aperture);
}

}  // namespace

// x [B, D, H, W, C], offset [B, D, H, W, 81] (tap-major (dD, dH, dW)),
// wmat [27*C, CO], bias [CO] or null, out [B, D, H, W, CO]; contiguous, one
// dtype (is_bf16 selects bf16, else f32). Returns cudaErrorInvalidValue for
// Co != CO, else cudaGetLastError() after the launch.
extern "C" int dpf_deform_conv3d(const void* x, const void* offset, const void* wmat,
                                 const void* bias, void* out, int B, int D, int H, int W, int C,
                                 int Co, int aperture, int is_bf16, void* stream) {
  if (Co != CO) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * D * H * W;
  dim3 grid((unsigned)((M + dpf::BM - 1) / dpf::BM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(grid, s, x, offset, wmat, bias, out, B, D, H, W, C, aperture);
  else
    launch<float>(grid, s, x, offset, wmat, bias, out, B, D, H, W, C, aperture);
  return (int)cudaGetLastError();
}
