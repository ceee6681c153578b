// T4: batched small product, the contraction primitive of the fused deform
// kernel. a [G, m, k] x b [G, k, 64] -> out [G, m, 64] in f32: products of
// the input dtype's values (exact in f32 for bf16), sums in f32.
//
// Replaces the TPU kernel `dot_bench` -> `kern` (tools/bench_vpu_prims.py:94,
// call at :104): one MXU `dot_general` per grid step with
// preferred_element_type f32.
//
// Bound on the H100: bytes, in both dtypes, once the products run on the
// tensor cores. bf16: at (m, k) = (128, 2240) the tensor cores would take a
// seventh of the time the memory does; at m = 32 less. f32: per g 36.7
// MFLOP against 1.75 MB; three TF32 passes (110 MFLOP at 495 TFLOP/s) take
// 43% of the time the 1.75 MB take at 3.35 TB/s (on the CUDA cores the
// products alone would take 5% longer than the bytes).
//
// Both dtypes: the tensor cores fed by TMA. A block owns one g and 64 MT
// rows of it (MT = 2 for m > 64, else 1: m = 32 reads one m64 tile whose
// rows past m are the TMA's zero fill) and all 64 columns. One producer
// warp keeps a ring of shared-memory stages full, each an A box [64 MT rows
// x one 128-byte row of k] of a 3-D tensor map over [G, m, k] (so rows past
// m read zeros, not the next g's rows) and b's rows of the same k, from a
// map over [G, k, 64], all in the 128-byte swizzle, with one full and one
// empty mbarrier per stage (tma.cuh). One consumer warpgroup multiplies
// each stage with f32 accumulators in registers. k past the end reads
// zeros.
//
// bf16: `wgmma` m64n64k16 on 4 stages of 64 k: A K-major as it lies, B
// MN-major (n contiguous) through the transpose-B flag, one group left in
// flight while the stage before it is released. Two or three blocks share
// an SM, so loads of one overlap the epilogue of another.
//
// f32: split-TF32 (3xTF32), `wgmma` m64n64k8 three times a k slice on
// operands split into bit-masked TF32 halves (a_lo b_hi + a_hi b_lo +
// a_hi b_hi, split_f32.py), which keeps the 1e-4 check of IEEE f32 (one
// TF32 pass would not). TF32 `wgmma` has no transpose flags, so both
// operands must be K-major. a is K-major as it lies: it is the register A
// operand, its fragments read from the stage's box and split in
// registers. b [k][64] is not: each stage's b (two [32 k x 32 n] boxes) is
// split by the consumers, in one pass through shared memory, into
// K-major hi and lo planes [64 n][32 k] in the 128-byte swizzle, B's
// layout. Of the two operands that pass moves the smaller (b is half of a
// at m = 128), and nothing is split in device memory beforehand: a pass
// over a or b there would add its bytes to a run the bytes bound. Two
// blocks share an SM, so the other block's products overlap a block's
// splits and fragment loads, and a thread has 168 registers: 64 hold the
// accumulators, so the products of one m64 row tile (its fragments, 32
// registers) are waited for before the next tile's fragments are read,
// and before the next stage's b is split. The planes are double-buffered,
// so one barrier a stage orders the split against the products before it.
// 3 stages of 32 k (24 KB at MT = 2) and the planes (2 x 16 KB) fit two
// blocks an SM.
//
// Epilogues store f32 rows with 16-byte stores through shared memory.
// k * element size must be a multiple of 16 bytes (TMA's global strides).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tc.cuh"
#include "tma.cuh"

namespace {

using namespace dpf;

constexpr int N = 64;
constexpr int CONSUMERS = 128;
constexpr int THREADS = CONSUMERS + 32;
constexpr int OUT_LD = N + 4;  // f32 row stride of the staged output tile

// ---- bf16: TMA ring + wgmma ----
constexpr int KSTEP = 64;    // k per stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int B_STAGE = KSTEP * N * 2;

__host__ __device__ constexpr int a_stage(int mt) { return mt * 64 * KSTEP * 2; }
__host__ __device__ constexpr int stage_bytes(int mt) { return a_stage(mt) + B_STAGE; }
__host__ __device__ constexpr int smem_bytes(int mt) { return STAGES * stage_bytes(mt) + 2 * STAGES * 8 + 1024; }

// ---- f32: TMA ring + 3xTF32 wgmma ----
constexpr int KSTEP32 = 32;  // k per stage: one 128-byte swizzle row of f32
constexpr int STAGES32 = 3;
constexpr int B_BOX32 = KSTEP32 * 32 * 4;  // one [32 k][32 n] box of b
constexpr int PLANES32 = 2 * N * 128;      // b's K-major planes [2][64 n][32 k] (hi, lo)

__host__ __device__ constexpr int a_stage32(int mt) { return mt * 64 * KSTEP32 * 4; }
__host__ __device__ constexpr int stage_bytes32(int mt) { return a_stage32(mt) + 2 * B_BOX32; }
__host__ __device__ constexpr int smem_bytes32(int mt) {
  return STAGES32 * stage_bytes32(mt) + 2 * PLANES32 + 2 * STAGES32 * 8 + 1024;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// Write the block's accumulators (wgmma m64n64 layout, MT row tiles) to
// out[g][m0 + r] for r < m - m0: staged in the (free) ring, then 16-byte
// stores.
template <int MT>
__device__ __forceinline__ void store_rows(const float (&acc)[MT][32], uint8_t* ring, float* __restrict__ out,
                                           int g, int m, int m0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  consumers_sync();
  float* tile = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int h = 0; h < MT; ++h)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = 64 * h + 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
      const int n = 8 * (e >> 2) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(&tile[r * OUT_LD + n]) = make_float2(acc[h][e], acc[h][e + 1]);
    }
  consumers_sync();
  const int rows = min(64 * MT, m - m0);
  float* dst = out + ((size_t)g * m + m0) * N;
  for (int v = tid; v < rows * (N / 4); v += CONSUMERS) {
    const int r = v / (N / 4), c = (v % (N / 4)) * 4;
    *reinterpret_cast<float4*>(&dst[(size_t)r * N + c]) = *reinterpret_cast<const float4*>(&tile[r * OUT_LD + c]);
  }
}

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

  // every load was consumed, so the ring is free
  store_rows<MT>(acc, ring, out, g, m, m0);
}

// One stage's b, two [32 k][32 n] TMA boxes (128-byte swizzle) at raw ->
// its K-major TF32 planes [64 n][32 k] at planes (hi, then lo; 128-byte
// swizzle). Consumer thread t splits column n = t % 64 at the k quads
// t / 64 + 2 i: 4 k of one n, read from 4 box rows, written as one 16-byte
// granule of each plane. A warp reads 32 n of one k row (one 128-byte row)
// and writes 8 consecutive plane rows per granule phase: both free of bank
// conflicts.
__device__ __forceinline__ void split_b_stage(const uint8_t* raw, uint8_t* planes, int tid) {
  const int n = tid & 63, half = tid >> 6;
  const uint8_t* col = raw + (n >> 5) * B_BOX32 + (n & 3) * 4;
  const int gran = (n & 31) >> 2;
#pragma unroll
  for (int i = 0; i < KSTEP32 / 8; ++i) {
    const int j = half + 2 * i;  // k = 4 j + c
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      tc::split_tf32(*reinterpret_cast<const float*>(col + tc::swizzle(4 * j + c, gran)), hi[c], lo[c]);
    *reinterpret_cast<uint4*>(planes + tc::swizzle(n, j)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(planes + N * 128 + tc::swizzle(n, j)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 2)
dot_3xtf32_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                  float* __restrict__ out, int m, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int STAGE = stage_bytes32(MT);
  uint8_t* planes = ring + STAGES32 * STAGE;  // two buffers of PLANES32
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + 2 * PLANES32);
  uint64_t* empty = full + STAGES32;
  const int g = blockIdx.y, m0 = blockIdx.x * 64 * MT;
  const int KT = (k + KSTEP32 - 1) / KSTEP32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < STAGES32; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], 1);
    }
    tma::fence_mbar_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES32;
        tma::mbar_wait(&empty[s], ((kt / STAGES32) & 1) ^ 1);
        tma::mbar_expect_tx(&full[s], STAGE);
        uint8_t* sa = ring + s * STAGE;
        tma::load_3d(sa, &amap, &full[s], kt * KSTEP32, m0, g);
        tma::load_3d(sa + a_stage32(MT), &bmap, &full[s], 0, kt * KSTEP32, g);
        tma::load_3d(sa + a_stage32(MT) + B_BOX32, &bmap, &full[s], 32, kt * KSTEP32, g);
      }
    }
    return;
  }

  float acc[MT][32];
#pragma unroll
  for (int h = 0; h < MT; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[h][e] = 0.0f;
  const uint32_t pbase = tc::smem_addr(planes);

  tma::mbar_wait(&full[0], 0);
  split_b_stage(ring + a_stage32(MT), planes, tid);
  tc::fence_proxy_async();  // the planes are written by the generic proxy, read by wgmma's
  consumers_sync();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES32;
    const uint8_t* ta = ring + s * STAGE;
    const uint32_t pb = pbase + (kt & 1) * PLANES32;
#pragma unroll
    for (int h = 0; h < MT; ++h) {  // a row tile's fragments are dead before the next tile's are read
      uint32_t ah[KSTEP32 / 8][4], al[KSTEP32 / 8][4];
#pragma unroll
      for (int kk = 0; kk < KSTEP32 / 8; ++kk) tc::a_fragment_3xtf32(ta, 64 * h + 16 * warp, 8 * kk, ah[kk], al[kk]);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEP32 / 8; ++kk)  // k slice kk is 32 bytes into each swizzled 128-byte row
        tc::mma_3xtf32<N>(acc[h], ah[kk], al[kk], pb + kk * 32, pb + N * 128 + kk * 32);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
    }
    if (kt + 1 < KT) {  // into the planes the products of stage kt - 1 read
      const int s1 = (kt + 1) % STAGES32;
      tma::mbar_wait(&full[s1], ((kt + 1) / STAGES32) & 1);
      split_b_stage(ring + s1 * STAGE + a_stage32(MT), planes + ((kt + 1) & 1) * PLANES32, tid);
      tc::fence_proxy_async();
    }
    consumers_sync();  // stage kt read, its products done, the next planes written
    if (tid == 0) tma::mbar_arrive(&empty[s]);
  }

  // every load was consumed, so the ring is free
  store_rows<MT>(acc, ring, out, g, m, m0);
}

// The tensor maps of a [G, m, k] (boxes of ks k x 64 mt rows) and b
// [G, k, 64] (boxes of bn n x ks k), elements of esize bytes.
int encode_maps(CUtensorMap* amap, CUtensorMap* bmap, CUtensorMapDataType type, int esize, const void* a,
                const void* b, int G, int m, int k, int ks, int mt, int bn) {
  const uint64_t adims[3] = {(uint64_t)k, (uint64_t)m, (uint64_t)G};
  const uint64_t astrides[2] = {(uint64_t)k * esize, (uint64_t)m * k * esize};
  const uint32_t abox[3] = {(uint32_t)ks, (uint32_t)(64 * mt), 1};
  const uint64_t bdims[3] = {(uint64_t)N, (uint64_t)k, (uint64_t)G};
  const uint64_t bstrides[2] = {(uint64_t)N * esize, (uint64_t)k * N * esize};
  const uint32_t bbox[3] = {(uint32_t)bn, (uint32_t)ks, 1};
  const int rc = tma::encode(amap, type, 3, a, adims, astrides, abox);
  return rc != 0 ? rc : tma::encode(bmap, type, 3, b, bdims, bstrides, bbox);
}

template <int MT>
int launch_bf16(const void* a, const void* b, float* out, int G, int m, int k, cudaStream_t s) {
  CUtensorMap amap, bmap;
  const int rc = encode_maps(&amap, &bmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, b, G, m, k, KSTEP, MT, N);
  if (rc != 0) return rc;
  auto kernel = dot_bf16_kernel<MT>;
  static const cudaError_t opted_in =  // once per instantiation and process (one card)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(MT));
  if (opted_in != cudaSuccess) return (int)opted_in;
  kernel<<<dim3((unsigned)((m + 64 * MT - 1) / (64 * MT)), (unsigned)G), THREADS, smem_bytes(MT), s>>>(
      amap, bmap, out, m, k);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_3xtf32(const void* a, const void* b, float* out, int G, int m, int k, cudaStream_t s) {
  CUtensorMap amap, bmap;
  const int rc = encode_maps(&amap, &bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a, b, G, m, k, KSTEP32, MT, 32);
  if (rc != 0) return rc;
  auto kernel = dot_3xtf32_kernel<MT>;
  static const cudaError_t opted_in =  // once per instantiation and process (one card)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes32(MT));
  if (opted_in != cudaSuccess) return (int)opted_in;
  kernel<<<dim3((unsigned)((m + 64 * MT - 1) / (64 * MT)), (unsigned)G), THREADS, smem_bytes32(MT), s>>>(
      amap, bmap, out, m, k);
  return (int)cudaGetLastError();
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
  return m > 64 ? launch_3xtf32<2>(a, b, o, G, m, k, s) : launch_3xtf32<1>(a, b, o, G, m, k, s);
}

// Dynamic shared memory of a block with mt m64 row tiles (1 or 2), bf16 and
// f32, for the build report.
extern "C" int dpf_batched_dot_smem_bytes(int mt) { return mt == 2 ? smem_bytes(2) : smem_bytes(1); }
extern "C" int dpf_batched_dot_3xtf32_smem_bytes(int mt) { return mt == 2 ? smem_bytes32(2) : smem_bytes32(1); }
