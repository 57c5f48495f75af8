// Fused masked-matmul kernels for Hopper (sm_90a), plain C interface.
//
// Replaces nine Pallas TPU kernels of bayestpu/kernels/masked_matmul.py:
//   dropout_matmul_kernel<float|bf16>  <- _dropout_matmul_kernel (:113-132),
//                                         called by dropout_matmul (:211-249)
//   dropout_matmul_samples_kernel<float|bf16>
//                                      <- _dropout_matmul_samples_kernel
//                                         (:286-311), dropout_matmul_samples
//   dropout_apply_kernel               <- _dropout_mask_kernel (:135-148),
//                                         called by _dropout_apply (:151-176)
//                                         in the backward of dropout_matmul
//   dropout_matmul_kernel<int8_t>      <- _dropout_matmul_int8_kernel
//                                         (:444-465), dropout_matmul_int8
//                                         (:468-516)
//   dropout_matmul_int8_samples_mma_kernel
//                                      <- _dropout_matmul_int8_samples_kernel
//                                         (:519-546),
//                                         dropout_matmul_int8_samples (:549)
//   bank_matmul_samples_kernel<int8_t, int8_t>
//                                      <- _bank_matmul_int8_samples_kernel
//                                         (:640-666),
//                                         bank_matmul_int8_samples (:669)
//   bank_matmul_kernel<int8_t, int8_t> <- _bank_matmul_int8_kernel
//                                         (:763-785), bank_matmul_int8 (:788)
//   bank_matmul_samples_kernel<float|bf16, float>
//                                      <- _bank_matmul_samples_kernel
//                                         (:863-885), bank_matmul_samples
//                                         (:888)
//   bank_matmul_kernel<float|bf16, float>
//                                      <- _bank_matmul_kernel (:843-860),
//                                         bank_matmul (:976)
// The MC-dropout float kernels compute out[s] = (x * keep_s(row, col) *
// scale) @ w in f32, where keep_s is the counter hash of prng.cuh on the
// GLOBAL, unpadded coordinates of x and seeds[s]. Under bf16 the product x *
// scale is rounded to bf16 (scale already rounded to bf16 by the caller),
// exactly as the JAX kernel computes it, and the dot is accumulated in f32.
// The int8 kernels mask the int8 x with the same bits, accumulate int8 x
// int8 in int32 (exact in any order) and write f32(acc) * out_scale, where
// out_scale is the f32 nearest to x_step * w_step / (1 - rate): the only
// roundings are int32 -> f32 and that one multiply, so they equal the JAX
// kernels bit for bit. The Masksembles (bank) kernels compute out[s] = (x *
// bank[idxs[s]]) @ w: the float ones in f32 (a bf16 x widened exactly, w and
// the bank f32, the bank's value multiplied, not binarized, as the JAX
// kernel's x_ref * row), the int8 ones with the row binarized as bank > 0.5
// and out_scale the f32 nearest to x_step * w_step (no dropout rescale).
//
// What bounds them on an H100: at the vgg11_me head shape (x 128x512, w
// 512x10, S = 10) one MC samples launch moves about 128 KiB of bf16 x (64
// KiB of int8 x), 10 KiB (5 KiB) of w and 51 KiB of output and does about
// 13 M operations: bytes bound, 0.06 us (0.036 us int8) at 3.35 TB/s,
// against 0.013 us of bf16 tensor-core time (0.007 us at the 1,979 TOP/s
// int8 peak). The Masksembles head (S = 4, bank 4x512 f32) moves 176 KiB
// (bf16 x, f32 w, the bank's four rows, f32 output: 0.054 us) and does 5.2
// M f32 multiply-adds' worth of operations, 0.078 us at the 67 TFLOP/s of
// f32 outside the tensor cores (its products are f32, which TF32 would
// round): operations bound; its int8 twin moves 97 KiB (0.030 us) for 0.003
// us of int8 operations, bytes bound. Every one is well under a launch, so
// the launch itself and the serial K loop of a few blocks set the pace. The
// design is the simple one, right first: one block per (16-row, 16-col)
// output tile loops over K in 32-deep tiles; each x tile is staged in
// shared memory ONCE and masked from there for every sample the block owns
// (up to 16, one accumulator each in registers), so x is read from device
// memory once for all samples. The mask is a policy of the one tile
// routine: the counter hash, or a bank row staged per k tile in shared
// memory. Ragged M, N and K edges are masked in the kernel, not padded in
// memory. Every kernel runs the same tile routine, so sample s of a samples
// kernel is bit-identical to the single kernel with seeds[s] or idxs[s].
// wgmma, TMA and pipelining are later work, but for the int8 MC samples
// head, which has a kernel of its own on the s8 tensor cores (below,
// before its entry point).
#include <cstddef>
#include <cstdint>
#include <type_traits>

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

// What the tile routine needs of an element type: V, the type a staged
// value and an accumulator have; load; scaled, the masked value before the
// dot; madd, one multiply-add; and out, the stored f32 result. For the
// float types `scale` is the dropout scale applied by `scaled`; for int8 it
// is out_scale, applied once by `out`.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using V = float;
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  // x * scale, rounded once to f32
  static __device__ __forceinline__ float scaled(float v, float s) {
    return __fmul_rn(v, s);
  }
  static __device__ __forceinline__ float madd(float a, float b, float acc) {
    return __fmaf_rn(a, b, acc);
  }
  static __device__ __forceinline__ float out(float acc, float) { return acc; }
};

template <>
struct Elem<__nv_bfloat16> {
  using V = float;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // x * scale, rounded to bf16 (the f32 product of two bf16 values is exact)
  static __device__ __forceinline__ float scaled(float v, float s) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, s)));
  }
  static __device__ __forceinline__ float madd(float a, float b, float acc) {
    return __fmaf_rn(a, b, acc);
  }
  static __device__ __forceinline__ float out(float acc, float) { return acc; }
};

template <>
struct Elem<int8_t> {
  using V = int32_t;
  static __device__ __forceinline__ int32_t load(const int8_t* p) {
    return *p;
  }
  // the int8 kernels mask without scaling; the scale comes once, in out()
  static __device__ __forceinline__ int32_t scaled(int32_t v, float) {
    return v;
  }
  static __device__ __forceinline__ int32_t madd(int32_t a, int32_t b,
                                                 int32_t acc) {
    return acc + a * b;
  }
  // f32(acc), rounded to nearest even, times the f32 out_scale
  static __device__ __forceinline__ float out(int32_t acc, float s) {
    return __fmul_rn(__int2float_rn(acc), s);
  }
};

// Mask policies of the tile routine. A policy masks one staged x value
// for one sample: `begin` loads what a block needs once (its samples' seed
// streams or bank row indices), `stage` what one k tile needs, and `apply`
// masks. Each keeps its own shared memory (`Smem`). The tile routine and
// its summation order are the same for every policy.

// MC dropout: the counter hash of prng.cuh on the GLOBAL coordinates of x;
// keep iff coord_bits(row, col, stream_s) < thresh, the kept value
// Elem::scaled by the dropout scale (the int8 kernels do not scale).
template <typename T, int NS>
struct HashMask {
  using V = typename Elem<T>::V;
  const int32_t* seeds;  // (S, 2)
  uint32_t thresh;
  float scale;
  struct Smem {
    uint32_t stream[NS];
  };
  __device__ __forceinline__ void begin(Smem& sm, int s0, int ns,
                                        int tid) const {
    if (tid < ns) {
      sm.stream[tid] = bayestpu::seed_stream(seeds[2 * (s0 + tid)],
                                             seeds[2 * (s0 + tid) + 1]);
    }
  }
  __device__ __forceinline__ void stage(Smem&, int, int, int) const {}
  __device__ __forceinline__ V apply(const Smem& sm, int s, int gr, int gc,
                                     int, V v) const {
    const uint32_t bits = bayestpu::coord_bits(
        static_cast<uint32_t>(gr), static_cast<uint32_t>(gc), sm.stream[s]);
    return bits < thresh ? Elem<T>::scaled(v, scale) : V(0);
  }
};

// Masksembles: sample s multiplies x by row idxs[s] of the f32 bank (n, K).
// The float kernels multiply by the bank's VALUE (x * row, rounded once to
// f32; a bf16 x widens exactly first); the int8 kernels binarize the row
// as bank > 0.5 and keep or zero the int8 x. `begin` takes every index
// modulo n with floor semantics (JAX's idx % n: -1 -> n - 1), so a row read
// stays in bounds whatever the caller passed, at no extra launch. The rows
// of a k tile are staged in shared memory once for the block's samples;
// columns beyond K read as 0.
template <typename T, int NS>
struct BankMask {
  using V = typename Elem<T>::V;
  const float* bank;     // (n, K) f32
  const int32_t* idxs;   // (S,) any int32; nullptr: every sample is idx0
  int idx0;
  int n;
  int K;
  struct Smem {
    int idx[NS];
    V row[NS][BK];
  };
  __device__ __forceinline__ void begin(Smem& sm, int s0, int ns,
                                        int tid) const {
    if (tid < ns) {
      const int r = (idxs != nullptr ? idxs[s0 + tid] : idx0) % n;
      sm.idx[tid] = r < 0 ? r + n : r;
    }
  }
  __device__ __forceinline__ void stage(Smem& sm, int k0, int ns,
                                        int tid) const {
    for (int i = tid; i < ns * BK; i += THREADS) {
      const int s = i / BK, c = i % BK, gc = k0 + c;
      const float b =
          gc < K ? bank[static_cast<size_t>(sm.idx[s]) * K + gc] : 0.f;
      if constexpr (std::is_same<V, float>::value) {
        sm.row[s][c] = b;
      } else {
        sm.row[s][c] = b > 0.5f ? V(1) : V(0);
      }
    }
  }
  __device__ __forceinline__ V apply(const Smem& sm, int s, int, int, int c,
                                     V v) const {
    if constexpr (std::is_same<V, float>::value) {
      return __fmul_rn(v, sm.row[s][c]);
    } else {
      return sm.row[s][c] != V(0) ? v : V(0);
    }
  }
};

// One (BM x BN) output tile for up to NS samples, samples
// [blockIdx.z * NS, blockIdx.z * NS + ns), x of element type TX masked by
// `mask`, w of type TW (the same staged type V), out f32:
// Elem<TX>::out(acc, out_scale).
template <typename TX, typename TW, int NS, typename Mask>
__device__ __forceinline__ void masked_tile_matmul(
    const TX* __restrict__ x, const TW* __restrict__ w, const Mask& mask,
    float* __restrict__ out, int M, int K, int N, int S, float out_scale) {
  using V = typename Elem<TX>::V;
  static_assert(std::is_same<V, typename Elem<TW>::V>::value,
                "x and w must stage as one type");
  __shared__ V xs[BM][BK];   // x tile as loaded
  __shared__ V xm[BM][BK];   // x tile under one sample's mask
  __shared__ V ws[BK][BN];
  __shared__ typename Mask::Smem msm;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int s0 = blockIdx.z * NS;
  const int ns = min(NS, S - s0);
  const int tr = tid / BN;
  const int tc = tid % BN;

  mask.begin(msm, s0, ns, tid);
  __syncthreads();
  V acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = V(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gc = k0 + c;
      xs[r][c] = (gr < M && gc < K)
                     ? Elem<TX>::load(x + static_cast<size_t>(gr) * K + gc)
                     : V(0);
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < K && gc < N)
                     ? Elem<TW>::load(w + static_cast<size_t>(gr) * N + gc)
                     : V(0);
    }
    mask.stage(msm, k0, ns, tid);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s < ns) {  // uniform over the block
        for (int i = tid; i < BM * BK; i += THREADS) {
          const int r = i / BK, c = i % BK;
          xm[r][c] = mask.apply(msm, s, row0 + r, k0 + c, c, xs[r][c]);
        }
        __syncthreads();
        V a = acc[s];
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          a = Elem<TX>::madd(xm[tr][kk], ws[kk][tc], a);
        }
        acc[s] = a;
        __syncthreads();
      }
    }
  }

  const int r = row0 + tr, c = col0 + tc;
  if (r < M && c < N) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s < ns) {
        out[(static_cast<size_t>(s0 + s) * M + r) * N + c] =
            Elem<TX>::out(acc[s], out_scale);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const int32_t* __restrict__ seeds,
                          float* __restrict__ out, int M, int K, int N,
                          uint32_t thresh, float scale) {
  masked_tile_matmul<T, T, 1>(x, w, HashMask<T, 1>{seeds, thresh, scale},
                              out, M, K, N, 1, scale);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_matmul_samples_kernel(const T* __restrict__ x,
                                  const T* __restrict__ w,
                                  const int32_t* __restrict__ seeds,
                                  float* __restrict__ out, int M, int K, int N,
                                  int S, uint32_t thresh, float scale) {
  masked_tile_matmul<T, T, SAMPLES_PER_BLOCK>(
      x, w, HashMask<T, SAMPLES_PER_BLOCK>{seeds, thresh, scale}, out, M, K,
      N, S, scale);
}

// Masksembles heads (rows 6-9 of the kernel table). One bank row per
// sample; sample s of the samples kernel runs the tile routine exactly as
// the single kernel does at idxs[s], so the two agree bit for bit.
template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
    bank_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                       const float* __restrict__ bank,
                       float* __restrict__ out, int M, int K, int N, int idx,
                       int n, float out_scale) {
  masked_tile_matmul<TX, TW, 1>(
      x, w, BankMask<TX, 1>{bank, nullptr, idx, n, K}, out, M, K, N, 1,
      out_scale);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
    bank_matmul_samples_kernel(const TX* __restrict__ x,
                               const TW* __restrict__ w,
                               const float* __restrict__ bank,
                               const int32_t* __restrict__ idxs,
                               float* __restrict__ out, int M, int K, int N,
                               int S, int n, float out_scale) {
  masked_tile_matmul<TX, TW, SAMPLES_PER_BLOCK>(
      x, w, BankMask<TX, SAMPLES_PER_BLOCK>{bank, idxs, 0, n, K}, out, M, K,
      N, S, out_scale);
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


// The int8 MC samples head (row 5) on the s8 tensor cores:
// out[s] = f32((x_q * keep_s) @ w_q) * out_scale, with keep_s the counter
// hash of HashMask on the global coordinates of x. A block owns 16 rows of
// x, 8 output columns and ONE sample (grid (ceil(M/16), ceil(N/8), S): 160
// blocks at the vgg11_me head, x 128x512, w 512x10, S = 10, where the
// shared routine above launched 8). Per K chunk of 512 it stages the x
// tile as int8, 16 bytes a thread, masked once per element as it is
// staged, and the w tile transposed to K-contiguous columns (B fragments),
// N padded with zeros to 8 in shared memory; its 4 warps split the chunk's
// k steps of mma.sync.m16n8k32 s8 -> s32 and the 4 partial sums are added
// in shared memory. The int32 sums are exact in any order, so the result
// equals the plain version and, per sample, the single kernel (row 4) bit
// for bit; the epilogue f32(acc) * out_scale runs once.
constexpr int I8_THREADS = 128;
constexpr int I8_BM = 16;                 // rows of x: one m16 tile
constexpr int I8_BN = 8;                  // columns of w: one n8 tile
constexpr int I8_KC = 512;                // bytes of K staged at a time
constexpr int I8_PITCH = I8_KC + 16;      // conflict-free 4-byte reads

__global__ void __launch_bounds__(I8_THREADS)
    dropout_matmul_int8_samples_mma_kernel(
        const int8_t* __restrict__ x, const int8_t* __restrict__ w,
        const int32_t* __restrict__ seeds, float* __restrict__ out, int M,
        int K, int N, uint32_t thresh, float out_scale) {
  __shared__ __align__(16) int8_t xs[I8_BM][I8_PITCH];
  __shared__ __align__(16) int8_t wt[I8_BN][I8_PITCH];
  __shared__ int32_t red[I8_THREADS / 32][I8_BM * I8_BN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * I8_BM, col0 = blockIdx.y * I8_BN;
  const int s = blockIdx.z;
  const uint32_t stream =
      bayestpu::seed_stream(seeds[2 * s], seeds[2 * s + 1]);
  const bool vec =
      K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int g = lane >> 2, t4 = lane & 3;
  int32_t acc[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < K; k0 += I8_KC) {
    for (int i = tid; i < I8_BM * (I8_KC / 16); i += I8_THREADS) {
      const int r = i / (I8_KC / 16), c = (i % (I8_KC / 16)) * 16;
      const int gr = row0 + r, gc = k0 + c;
      alignas(16) int8_t e[16];
      if (gr < M && gc < K && vec) {
        *reinterpret_cast<uint4*>(e) = __ldg(reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(gr) * K + gc));
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          e[j] = gr < M && gc + j < K ? x[static_cast<size_t>(gr) * K + gc + j]
                                      : int8_t(0);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t bits = bayestpu::coord_bits(
            static_cast<uint32_t>(gr), static_cast<uint32_t>(gc + j), stream);
        if (bits >= thresh) e[j] = 0;
      }
      *reinterpret_cast<uint4*>(&xs[r][c]) = *reinterpret_cast<uint4*>(e);
    }
    for (int i = tid; i < I8_BN * I8_KC; i += I8_THREADS) {
      const int kk = i / I8_BN, n = i % I8_BN;
      const int gk = k0 + kk, gn = col0 + n;
      wt[n][kk] = gk < K && gn < N ? w[static_cast<size_t>(gk) * N + gn]
                                   : int8_t(0);
    }
    __syncthreads();
    for (int kb = warp * 32; kb < I8_KC; kb += 32 * (I8_THREADS / 32)) {
      const uint32_t a[4] = {
          *reinterpret_cast<const uint32_t*>(&xs[g][kb + 4 * t4]),
          *reinterpret_cast<const uint32_t*>(&xs[g + 8][kb + 4 * t4]),
          *reinterpret_cast<const uint32_t*>(&xs[g][kb + 16 + 4 * t4]),
          *reinterpret_cast<const uint32_t*>(&xs[g + 8][kb + 16 + 4 * t4])};
      const uint32_t b0 =
          *reinterpret_cast<const uint32_t*>(&wt[g][kb + 4 * t4]);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(&wt[g][kb + 16 + 4 * t4]);
      asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
    __syncthreads();
  }
  // accumulator r of the warp: row g (+8 for r >= 2), column 2·t4 (+1 odd)
#pragma unroll
  for (int r = 0; r < 4; ++r)
    red[warp][(g + (r >> 1) * 8) * I8_BN + 2 * t4 + (r & 1)] = acc[r];
  __syncthreads();
  const int r = tid / I8_BN, c = tid % I8_BN;
  int32_t sum = 0;
#pragma unroll
  for (int v = 0; v < I8_THREADS / 32; ++v) sum += red[v][tid];
  const int gr = row0 + r, gc = col0 + c;
  if (gr < M && gc < N)
    out[(static_cast<size_t>(s) * M + gr) * N + gc] =
        Elem<int8_t>::out(sum, out_scale);
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

extern "C" int bt_dropout_matmul_int8(const void* x, const void* w,
                                      const void* seeds, void* out, int M,
                                      int K, int N, uint32_t thresh,
                                      float out_scale, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, 1);
  dropout_matmul_kernel<int8_t>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
          static_cast<const int32_t*>(seeds), static_cast<float*>(out), M, K,
          N, thresh, out_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_dropout_matmul_int8_samples(const void* x, const void* w,
                                              const void* seeds, void* out,
                                              int M, int K, int N, int S,
                                              uint32_t thresh,
                                              float out_scale, void* stream) {
  const dim3 grid((M + I8_BM - 1) / I8_BM, (N + I8_BN - 1) / I8_BN, S);
  dropout_matmul_int8_samples_mma_kernel<<<grid, I8_THREADS, 0,
                                           static_cast<cudaStream_t>(
                                               stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(seeds), static_cast<float*>(out), M, K, N,
      thresh, out_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_bank_matmul(const void* x, const void* w, const void* bank,
                              void* out, int M, int K, int N, int idx,
                              int n, int is_bf16, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, 1);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(bank);
  const auto* wf = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  if (is_bf16) {
    bank_matmul_kernel<__nv_bfloat16, float><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wf, b, o, M, K, N, idx, n,
        1.f);
  } else {
    bank_matmul_kernel<float, float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), wf, b, o, M, K, N, idx, n, 1.f);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_bank_matmul_samples(const void* x, const void* w,
                                      const void* bank, const void* idxs,
                                      void* out, int M, int K, int N, int S,
                                      int n, int is_bf16, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN,
                  (S + SAMPLES_PER_BLOCK - 1) / SAMPLES_PER_BLOCK);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(bank);
  const auto* ix = static_cast<const int32_t*>(idxs);
  const auto* wf = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  if (is_bf16) {
    bank_matmul_samples_kernel<__nv_bfloat16, float>
        <<<grid, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x), wf,
                                   b, ix, o, M, K, N, S, n, 1.f);
  } else {
    bank_matmul_samples_kernel<float, float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), wf, b, ix, o, M, K, N, S, n, 1.f);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_bank_matmul_int8(const void* x, const void* w,
                                   const void* bank, void* out, int M, int K,
                                   int N, int idx, int n, float out_scale,
                                   void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, 1);
  bank_matmul_kernel<int8_t, int8_t>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(bank), static_cast<float*>(out), M, K, N,
          idx, n, out_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_bank_matmul_int8_samples(const void* x, const void* w,
                                           const void* bank, const void* idxs,
                                           void* out, int M, int K, int N,
                                           int S, int n, float out_scale,
                                           void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN,
                  (S + SAMPLES_PER_BLOCK - 1) / SAMPLES_PER_BLOCK);
  bank_matmul_samples_kernel<int8_t, int8_t>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(bank), static_cast<const int32_t*>(idxs),
          static_cast<float*>(out), M, K, N, S, n, out_scale);
  return static_cast<int>(cudaGetLastError());
}
