// T4: batched small product, the contraction primitive of the fused deform
// kernel. a [G, m, k] x b [G, k, 64] -> out [G, m, 64] in f32: products of
// the input dtype's values (exact in f32 for bf16), sums in f32.
//
// Replaces the TPU kernel `dot_bench` -> `kern` (tools/bench_vpu_prims.py:94,
// call at :104): one MXU `dot_general` per grid step with
// preferred_element_type f32.
//
// Bound on the H100: in bf16, bytes (at (m, k) = (128, 2240) the tensor
// cores would take a seventh of the time the memory does; at m = 32 less);
// in f32, operations on the CUDA cores, barely (per g 36.7 MFLOP against
// 1.75 MB: 21 FLOP per byte, just above the f32 ridge of 67 TFLOP/s over
// 3.35 TB/s). The two dtypes take two designs.
//
// bf16: the tensor cores fed by TMA. A block owns one g and 64 MT rows of it
// (MT = 2 for m > 64, else 1: m = 32 reads one m64 tile whose rows past m
// are the TMA's zero fill) and all 64 columns. One producer warp keeps a
// ring of STAGES shared-memory stages full, each an A box [64 MT rows x 64 k]
// of a 3-D tensor map over [G, m, k] (so rows past m read zeros, not the
// next g's rows) and a B box [64 k x 64 n] of a map over [G, k, 64], both
// in the 128-byte swizzle, with one full and one empty mbarrier per stage
// (tma.cuh). One consumer warpgroup runs `wgmma` m64n64k16 on each stage:
// A K-major as it lies, B MN-major (n contiguous) through the transpose-B
// flag, f32 accumulators in registers, one group left in flight while the
// stage before it is released. Two or three blocks share an SM, so loads of
// one overlap the epilogue of another. k past the end reads zeros.
//
// f32: exact f32 FMA on the CUDA cores (the contract of the plain version
// and of the JAX oracle, which runs the body in exact f32; wgmma takes tf32
// only K-major and rounds its inputs). A block of 128 threads owns 128 rows
// and all 64 columns; each thread keeps 8 x 8 accumulators (rows ty + 16 i,
// columns 4 tx + j and 32 + 4 tx + j). A and B tiles of BKF = 16 k are
// staged by cp.async, double-buffered, each in its own layout (no transpose
// on the way in). Per 4 k a thread reads its 8 rows as 8 16-byte loads and
// B as 8 more: 16 FMA per shared-memory load. The 8 threads of a
// quarter-warp share their rows (one broadcast address) and read B's 8
// consecutive 16-byte granules, so the reads are free of bank conflicts
// without a swizzle.
//
// Epilogues store f32 rows with 16-byte stores (bf16: through shared
// memory). k * element size must be a multiple of 16 bytes (TMA's global
// strides, cp.async's granule).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tc.cuh"
#include "tma.cuh"

namespace {

using namespace dpf;

constexpr int N = 64;

// ---- bf16: TMA ring + wgmma ----
constexpr int KSTEP = 64;    // k per stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 128;
constexpr int THREADS = CONSUMERS + 32;
constexpr int B_STAGE = KSTEP * N * 2;
constexpr int OUT_LD = N + 4;  // f32 row stride of the staged output tile

__host__ __device__ constexpr int a_stage(int mt) { return mt * 64 * KSTEP * 2; }
__host__ __device__ constexpr int stage_bytes(int mt) { return a_stage(mt) + B_STAGE; }
__host__ __device__ constexpr int smem_bytes(int mt) { return STAGES * stage_bytes(mt) + 2 * STAGES * 8 + 1024; }

template <int MT>
__global__ void __launch_bounds__(THREADS)
dot_bf16_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                float* __restrict__ out, int m, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int STAGE = stage_bytes(MT);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int g = blockIdx.y, m0 = blockIdx.x * 64 * MT;
  const int KT = (k + KSTEP - 1) / KSTEP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], CONSUMERS / 32);
    }
    tma::fence_mbar_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        tma::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        tma::mbar_expect_tx(&full[s], STAGE);
        uint8_t* sa = ring + s * STAGE;
        tma::load_3d(sa, &amap, &full[s], kt * KSTEP, m0, g);
        tma::load_3d(sa + a_stage(MT), &bmap, &full[s], 0, kt * KSTEP, g);
      }
    }
    return;
  }

  float acc[MT][32];
#pragma unroll
  for (int h = 0; h < MT; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[h][e] = 0.0f;
  const uint32_t base = tc::smem_addr(ring);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    tma::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t sa = base + s * STAGE, sb = sa + a_stage(MT);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEP / 16; ++kk) {
      const uint64_t db = tc::desc(sb + kk * 2048);
#pragma unroll
      for (int h = 0; h < MT; ++h) tc::Wgmma<64, 0, 1>::mma(acc[h], tc::desc(sa + h * 64 * 128 + kk * 32), db);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // the stage before this one is read: release it
    if (kt > 0 && lane == 0) tma::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  tc::wgmma_wait<0>();

  // every load was consumed, so the ring is free: stage the f32 tile there
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  float* tile = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int h = 0; h < MT; ++h)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = 64 * h + 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
      const int n = 8 * (e >> 2) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(&tile[r * OUT_LD + n]) = make_float2(acc[h][e], acc[h][e + 1]);
    }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  const int rows = min(64 * MT, m - m0);
  float* dst = out + ((size_t)g * m + m0) * N;
  for (int v = tid; v < rows * (N / 4); v += CONSUMERS) {
    const int r = v / (N / 4), c = (v % (N / 4)) * 4;
    *reinterpret_cast<float4*>(&dst[(size_t)r * N + c]) = *reinterpret_cast<const float4*>(&tile[r * OUT_LD + c]);
  }
}

template <int MT>
int launch_bf16(const void* a, const void* b, float* out, int G, int m, int k, cudaStream_t s) {
  CUtensorMap amap, bmap;
  const uint64_t adims[3] = {(uint64_t)k, (uint64_t)m, (uint64_t)G};
  const uint64_t astrides[2] = {(uint64_t)k * 2, (uint64_t)m * k * 2};
  const uint32_t abox[3] = {KSTEP, 64 * MT, 1};
  const uint64_t bdims[3] = {(uint64_t)N, (uint64_t)k, (uint64_t)G};
  const uint64_t bstrides[2] = {(uint64_t)N * 2, (uint64_t)k * N * 2};
  const uint32_t bbox[3] = {N, KSTEP, 1};
  int rc = tma::encode(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a, adims, astrides, abox);
  if (rc != 0) return rc;
  rc = tma::encode(&bmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, b, bdims, bstrides, bbox);
  if (rc != 0) return rc;
  auto kernel = dot_bf16_kernel<MT>;
  static const cudaError_t opted_in =  // once per instantiation and process (one card)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(MT));
  if (opted_in != cudaSuccess) return (int)opted_in;
  kernel<<<dim3((unsigned)((m + 64 * MT - 1) / (64 * MT)), (unsigned)G), THREADS, smem_bytes(MT), s>>>(
      amap, bmap, out, m, k);
  return (int)cudaGetLastError();
}

// ---- f32: register-blocked SIMT tile ----
constexpr int BMF = 128;
constexpr int BKF = 16;
constexpr int THREADS_F = 128;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tc::smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__global__ void __launch_bounds__(THREADS_F)
dot_f32_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out, int m, int k) {
  __shared__ __align__(16) float As[2][BMF][BKF];
  __shared__ __align__(16) float Bs[2][BKF][N];
  const int g = blockIdx.y, m0 = blockIdx.x * BMF;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const float* ag = a + (size_t)g * m * k;
  const float* bg = b + (size_t)g * k * N;
  const int KT = (k + BKF - 1) / BKF;

  auto load = [&](int st, int kt) {
    const int k0 = kt * BKF;
#pragma unroll
    for (int p = 0; p < BMF * BKF / 4 / THREADS_F; ++p) {
      const int q = tid + THREADS_F * p, row = q >> 2, c = (q & 3) * 4;
      const bool ok = m0 + row < m && k0 + c < k;
      cp_async16(&As[st][row][c], ok ? ag + (size_t)(m0 + row) * k + k0 + c : ag, ok);
    }
#pragma unroll
    for (int p = 0; p < BKF * N / 4 / THREADS_F; ++p) {
      const int q = tid + THREADS_F * p, row = q >> 4, c = (q & 15) * 4;
      const bool ok = k0 + row < k;
      cp_async16(&Bs[st][row][c], ok ? bg + (size_t)(k0 + row) * N + c : bg, ok);
    }
    tc::cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) {
      load(st ^ 1, kt + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BKF; k4 += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(&As[st][ty + 16 * i][k4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[st][k4 + kk][4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[st][k4 + kk][32 + 4 * tx]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the stage is read before the next load overwrites it
  }
  float* og = out + (size_t)g * m * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
    float* o = og + (size_t)row * N;
    *reinterpret_cast<float4*>(o + 4 * tx) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + 32 + 4 * tx) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace

// a [G, m, k], b [G, k, 64] (one dtype: is_bf16 selects bf16, else f32),
// out [G, m, 64] f32; all contiguous and 16-byte aligned. Returns
// cudaErrorInvalidValue for n != 64, a k whose rows are no multiple of 16
// bytes or a misaligned pointer, else the first error of the tensor maps'
// encoding or the launch.
extern "C" int dpf_batched_dot(const void* a, const void* b, void* out, int G, int m, int k, int n,
                               int is_bf16, void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  if (n != N || G < 1 || m < 1 || k < 1 || (k * esize) % 16 != 0 ||
      ((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (is_bf16) return m > 64 ? launch_bf16<2>(a, b, o, G, m, k, s) : launch_bf16<1>(a, b, o, G, m, k, s);
  dot_f32_kernel<<<dim3((unsigned)((m + BMF - 1) / BMF), (unsigned)G), THREADS_F, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), o, m, k);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the bf16 block with mt m64 row tiles (1 or 2),
// for the build report.
extern "C" int dpf_batched_dot_smem_bytes(int mt) { return mt == 2 ? smem_bytes(2) : smem_bytes(1); }
