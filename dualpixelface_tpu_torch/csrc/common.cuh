// Shared pieces of the port's CUDA kernels: dtype conversions and the SIMT
// im2col-GEMM tile of T1's f32 route (dense 3x3x3 conv; its bf16 route,
// and every route of K1, K2 and K5, run on the tensor cores, conv_tc.cuh).
//
// The GEMM tile is a plain SIMT design: a block of 256 threads (16 x 16)
// owns BM = 128 output voxels x all Co <= 16*TN output channels; each thread
// keeps TM x TN f32 accumulators for voxels ty + 16*i and channels
// tx + 16*j. The A tile (BK reduction rows x BM voxels) is built by the
// calling kernel in shared memory, already rounded to the input dtype; the
// B tile is BK rows of the [K, Co] weight matrix. No tensor cores yet.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dpf {

constexpr int BM = 128;
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int NTHREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value through the storage type T (identity for f32).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The TM output voxels m0 + 16 r of an implicit-GEMM conv thread: the flat
// index vm and its (d, h, w) in a [., D, H, W] volume.
__device__ __forceinline__ void conv_voxels(int m0, int D, int H, int W, int (&vm)[TM], int (&vd)[TM],
                                            int (&vh)[TM], int (&vw)[TM]) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + 16 * r;
    vm[r] = m;
    int t = m;
    vw[r] = t % W; t /= W;
    vh[r] = t % H; t /= H;
    vd[r] = t % D;
  }
}

// The A tile of a dense 3x3x3 pad-1 stride-1 conv over x [B, D, H, W, C]
// as an implicit GEMM over the flattened (tap, channel) axis, K = 27 C:
// As[tx][ty + 16 r] = x at the voxel conv_voxels gave, shifted by the tap of
// row k = k0 + tx, channel k % C; 0 outside the volume (the zero padding) or
// past K or M.
template <typename T>
__device__ __forceinline__ void load_conv_a_tile(float (*As)[BM + 1], const T* __restrict__ x,
                                                 const int (&vm)[TM], const int (&vd)[TM],
                                                 const int (&vh)[TM], const int (&vw)[TM], int k0,
                                                 int M, int D, int H, int W, int C, int tx, int ty) {
  const int K = 27 * C;
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
}

// Bs[k][n] = W[krow0 + k][n] for k < nk and n < Co, else 0.
template <typename T, int TN>
__device__ __forceinline__ void load_b_tile(float (*Bs)[16 * TN], const T* __restrict__ wmat,
                                            int krow0, int nk, int Co, int tid) {
  constexpr int BN = 16 * TN;
  for (int e = tid; e < BK * BN; e += NTHREADS) {
    const int k = e / BN, n = e - k * BN;
    float v = 0.0f;
    if (k < nk && n < Co) v = to_f32(wmat[(size_t)(krow0 + k) * Co + n]);
    Bs[k][n] = v;
  }
}

template <int TN>
__device__ __forceinline__ void mma_tile(float (*As)[BM + 1], float (*Bs)[16 * TN],
                                         float (&acc)[TM][TN], int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// out[m][n] = T(acc) (+ bias[n], added in the output dtype: the sum of the
// two T values is taken in f32 and rounded once, as torch adds in T).
template <typename T, int TN>
__device__ __forceinline__ void store_tile(T* __restrict__ out, const T* __restrict__ bias,
                                           float (&acc)[TM][TN], int m0, int M, int Co, int tx,
                                           int ty) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 16 * j;
      if (n >= Co) continue;
      float v = round_to<T>(acc[i][j]);
      if (bias != nullptr) v = v + to_f32(bias[n]);
      out[(size_t)m * Co + n] = from_f32<T>(v);
    }
  }
}

}  // namespace dpf
