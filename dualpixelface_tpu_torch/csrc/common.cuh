// Shared pieces of the port's CUDA kernels: dtype conversions and the
// im2col-GEMM tile that K1 (deform conv) and K5 (dense 3x3x3 conv) share.
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
