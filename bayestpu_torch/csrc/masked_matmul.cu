// Fused MC-dropout matmul kernels for Hopper (sm_90a), plain C interface.
//
// Replaces three Pallas TPU kernels of bayestpu/kernels/masked_matmul.py:
//   dropout_matmul_kernel          <- _dropout_matmul_kernel (:113-132),
//                                     called by dropout_matmul (:211-249)
//   dropout_matmul_samples_kernel  <- _dropout_matmul_samples_kernel
//                                     (:286-311), dropout_matmul_samples
//   dropout_apply_kernel           <- _dropout_mask_kernel (:135-148),
//                                     called by _dropout_apply (:151-176)
//                                     in the backward of dropout_matmul
// Both compute out[s] = (x * keep_s(row, col) * scale) @ w in f32, where
// keep_s is the counter hash of prng.cuh on the GLOBAL, unpadded coordinates
// of x and seeds[s]. Under bf16 the product x * scale is rounded to bf16
// (scale already rounded to bf16 by the caller), exactly as the JAX kernel
// computes it, and the dot is accumulated in f32.
//
// What bounds them on an H100: at the vgg11_me head shape (x 128x512 bf16,
// w 512x10, S = 10) one samples launch moves about 128 KiB of x, 10 KiB of w
// and 51 KiB of output and does about 13 MFLOP: well under a microsecond of
// memory or tensor-core time, so the launch itself and the serial K loop of
// a few blocks set the pace. The design is the simple one, right first:
// one block per (16-row, 16-col) output tile loops over K in 32-deep tiles;
// each x tile is staged in shared memory ONCE and masked from there for
// every sample the block owns (up to 16, one f32 accumulator each in
// registers), so x is read from device memory once for all samples. Ragged
// M, N and K edges are masked in the kernel, not padded in memory. Both
// kernels run the same tile routine, so sample s of the samples kernel is
// bit-identical to the single kernel with seeds[s]. wgmma, TMA and
// pipelining are later work.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "prng.cuh"

namespace {

constexpr int BM = 16;                  // rows of x and out per block
constexpr int BN = 16;                  // columns of w and out per block
constexpr int BK = 32;                  // depth of one staged k tile
constexpr int THREADS = BM * BN;        // one output element per thread
constexpr int SAMPLES_PER_BLOCK = 16;   // samples kernel: grid.z splits S
constexpr int APPLY_THREADS = 256;      // dropout_apply: threads per block
constexpr int APPLY_MAX_BLOCKS = 132 * 16;  // grid-stride beyond this

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  // x * scale, rounded once to f32
  static __device__ __forceinline__ float scaled(float v, float s) {
    return __fmul_rn(v, s);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // x * scale, rounded to bf16 (the f32 product of two bf16 values is exact)
  static __device__ __forceinline__ float scaled(float v, float s) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, s)));
  }
};

// One (BM x BN) output tile for up to NS samples, samples
// [blockIdx.z * NS, blockIdx.z * NS + ns).
template <typename T, int NS>
__device__ __forceinline__ void masked_tile_matmul(
    const T* __restrict__ x, const T* __restrict__ w,
    const int32_t* __restrict__ seeds, float* __restrict__ out, int M, int K,
    int N, int S, uint32_t thresh, float scale) {
  __shared__ float xs[BM][BK];   // x tile as loaded
  __shared__ float xm[BM][BK];   // x tile under one sample's mask
  __shared__ float ws[BK][BN];
  __shared__ uint32_t streams[NS];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int s0 = blockIdx.z * NS;
  const int ns = min(NS, S - s0);
  const int tr = tid / BN;
  const int tc = tid % BN;

  if (tid < ns) {
    streams[tid] = bayestpu::seed_stream(seeds[2 * (s0 + tid)],
                                         seeds[2 * (s0 + tid) + 1]);
  }
  float acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gc = k0 + c;
      xs[r][c] = (gr < M && gc < K)
                     ? Elem<T>::load(x + static_cast<size_t>(gr) * K + gc)
                     : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < K && gc < N)
                     ? Elem<T>::load(w + static_cast<size_t>(gr) * N + gc)
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s < ns) {  // uniform over the block
        for (int i = tid; i < BM * BK; i += THREADS) {
          const int r = i / BK, c = i % BK;
          const uint32_t bits = bayestpu::coord_bits(
              static_cast<uint32_t>(row0 + r), static_cast<uint32_t>(k0 + c),
              streams[s]);
          xm[r][c] = bits < thresh ? Elem<T>::scaled(xs[r][c], scale) : 0.f;
        }
        __syncthreads();
        float a = acc[s];
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) a = __fmaf_rn(xm[tr][kk], ws[kk][tc], a);
        acc[s] = a;
        __syncthreads();
      }
    }
  }

  const int r = row0 + tr, c = col0 + tc;
  if (r < M && c < N) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s < ns) out[(static_cast<size_t>(s0 + s) * M + r) * N + c] = acc[s];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const int32_t* __restrict__ seeds,
                          float* __restrict__ out, int M, int K, int N,
                          uint32_t thresh, float scale) {
  masked_tile_matmul<T, 1>(x, w, seeds, out, M, K, N, 1, thresh, scale);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_matmul_samples_kernel(const T* __restrict__ x,
                                  const T* __restrict__ w,
                                  const int32_t* __restrict__ seeds,
                                  float* __restrict__ out, int M, int K, int N,
                                  int S, uint32_t thresh, float scale) {
  masked_tile_matmul<T, SAMPLES_PER_BLOCK>(x, w, seeds, out, M, K, N, S,
                                           thresh, scale);
}

// dropout(x) alone: out[r, c] = keep(r, c) ? f32(x[r, c]) * scale : 0, with
// the mask bit for bit that of the forward kernels (same hash, same global
// coordinates). The backward of dropout_matmul applies it to g @ w^T (f32)
// and to x (f32 or bf16) instead of storing the forward's mask. The scale
// is f32(1 / (1 - rate)) whatever x's dtype, and the product is rounded
// once to f32, as the JAX kernel casts to f32 before it multiplies.
//
// What bounds it on an H100: an elementwise pass, so memory. At the
// vgg11_me head shape (128 x 512) it reads 128 KiB (bf16) or 256 KiB (f32)
// and writes 256 KiB: 0.117 us or 0.156 us at 3.35 TB/s, far below a
// launch. The design is the simple one: a grid-stride loop, one element per
// thread per trip, neighbouring threads on neighbouring addresses so loads
// and stores coalesce; the seed stream is hashed once per thread.
template <typename T>
__global__ void __launch_bounds__(APPLY_THREADS)
    dropout_apply_kernel(const T* __restrict__ x,
                         const int32_t* __restrict__ seeds,
                         float* __restrict__ out, int M, int K,
                         uint32_t thresh, float scale) {
  const uint32_t stream = bayestpu::seed_stream(seeds[0], seeds[1]);
  const size_t n = static_cast<size_t>(M) * K;
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const uint32_t r = static_cast<uint32_t>(i / K);
    const uint32_t c = static_cast<uint32_t>(i % K);
    const uint32_t bits = bayestpu::coord_bits(r, c, stream);
    out[i] = bits < thresh ? __fmul_rn(Elem<T>::load(x + i), scale) : 0.f;
  }
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success); it neither allocates nor synchronises.
extern "C" int bt_dropout_matmul(const void* x, const void* w,
                                 const void* seeds, void* out, int M, int K,
                                 int N, uint32_t thresh, float scale,
                                 int is_bf16, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, 1);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sd = static_cast<const int32_t*>(seeds);
  auto* o = static_cast<float*>(out);
  if (is_bf16) {
    dropout_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), sd, o, M, K, N, thresh, scale);
  } else {
    dropout_matmul_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sd, o, M,
        K, N, thresh, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_dropout_matmul_samples(const void* x, const void* w,
                                         const void* seeds, void* out, int M,
                                         int K, int N, int S, uint32_t thresh,
                                         float scale, int is_bf16,
                                         void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN,
                  (S + SAMPLES_PER_BLOCK - 1) / SAMPLES_PER_BLOCK);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sd = static_cast<const int32_t*>(seeds);
  auto* o = static_cast<float*>(out);
  if (is_bf16) {
    dropout_matmul_samples_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), sd, o, M, K, N, S, thresh,
        scale);
  } else {
    dropout_matmul_samples_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sd, o, M,
        K, N, S, thresh, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_dropout_apply(const void* x, const void* seeds, void* out,
                                int M, int K, uint32_t thresh, float scale,
                                int is_bf16, void* stream) {
  const size_t n = static_cast<size_t>(M) * K;
  const size_t want = (n + APPLY_THREADS - 1) / APPLY_THREADS;
  const dim3 grid(static_cast<unsigned>(
      want < APPLY_MAX_BLOCKS ? want : APPLY_MAX_BLOCKS));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sd = static_cast<const int32_t*>(seeds);
  auto* o = static_cast<float*>(out);
  if (is_bf16) {
    dropout_apply_kernel<__nv_bfloat16><<<grid, APPLY_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), sd, o, M, K, thresh, scale);
  } else {
    dropout_apply_kernel<float><<<grid, APPLY_THREADS, 0, st>>>(
        static_cast<const float*>(x), sd, o, M, K, thresh, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
