// Fused masked-matmul kernels for Hopper (sm_90a), plain C interface.
//
// Replaces nine Pallas TPU kernels of bayestpu/kernels/masked_matmul.py:
//   chain_samples_kernel<HashChain<float|bf16>>
//                                      <- _dropout_matmul_kernel (:113-132),
//                                         called by dropout_matmul (:211-249),
//                                         at one sample; and
//                                         _dropout_matmul_samples_kernel
//                                         (:286-311), dropout_matmul_samples;
//                                         with x carrying the sample axis,
//                                         the lax.map fallback of
//                                         dropout_matmul_inference (:407-411)
//   dropout_apply_kernel               <- _dropout_mask_kernel (:135-148),
//                                         called by _dropout_apply (:151-176)
//                                         in the backward of dropout_matmul
//   int8_samples_mma_kernel<HashStage, I8_SPLIT>
//                                      <- _dropout_matmul_int8_kernel
//                                         (:444-465), dropout_matmul_int8
//                                         (:468-516)
//   int8_samples_mma_kernel<HashStage, 1>
//                                      <- _dropout_matmul_int8_samples_kernel
//                                         (:519-546),
//                                         dropout_matmul_int8_samples (:549);
//                                         with x carrying the sample axis,
//                                         the lax.map fallback of
//                                         dropout_matmul_int8_inference
//                                         (:618-622)
//   int8_samples_mma_kernel<BankStage, 1>
//                                      <- _bank_matmul_int8_samples_kernel
//                                         (:640-666),
//                                         bank_matmul_int8_samples (:669);
//                                         with x carrying the sample axis,
//                                         the lax.map fallback of
//                                         bank_matmul_int8_inference
//                                         (:742-747)
//   int8_samples_mma_kernel<BankStage, I8_SPLIT>
//                                      <- _bank_matmul_int8_kernel
//                                         (:763-785), bank_matmul_int8 (:788)
//   chain_samples_kernel<BankChain<float|bf16>>
//                                      <- _bank_matmul_kernel (:843-860),
//                                         bank_matmul (:976), at one sample;
//                                         and _bank_matmul_samples_kernel
//                                         (:863-885), bank_matmul_samples
//                                         (:888); with x carrying the sample
//                                         axis, the lax.map fallback of
//                                         bank_matmul_inference (:957-960)
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
// the launch itself, the number of blocks in flight and the serial chains
// inside them set the pace.
// Each kernel has a design of its own (below, before the entry points):
// the float heads (rows 2, 3, 8 and 9) on the CUDA cores, warp-specialised,
// one block per (8 rows, 16 columns, sample); the int8 heads (rows 4-7) on
// the s8 tensor cores. Sample s of every samples kernel is bit-identical to
// its single kernel with seeds[s] or idxs[s]: rows 2 and 3, and rows 8 and
// 9, because each pair is one kernel, the int8 ones because int32 sums are
// exact in any order.
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "prng.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int APPLY_THREADS = 256;      // dropout_apply: threads per block

// The element types: load widens a float x to f32 (dropout_apply); out
// is the int8 heads' epilogue.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <>
struct Elem<int8_t> {
  // f32(acc), rounded to nearest even, times the f32 out_scale
  static __device__ __forceinline__ float out(int32_t acc, float s) {
    return __fmul_rn(__int2float_rn(acc), s);
  }
};

// dropout(x) alone: out[r, c] = keep(r, c) ? f32(x[r, c]) * scale : 0, with
// the mask bit for bit that of the forward kernels (same hash, same global
// coordinates). The backward of dropout_matmul applies it to g @ w^T (f32)
// and to x (f32 or bf16) instead of storing the forward's mask, and the
// conv backward to the (N*H*W, C) view of a site's input and of its input
// gradient. The scale is f32(1 / (1 - rate)) whatever x's dtype, and the
// product is rounded once to f32, as the JAX kernel casts to f32 before it
// multiplies.
//
// What bounds it on an H100: memory. It reads x (2 or 4 bytes an element)
// and writes 4 bytes an element, against ~25 integer operations of the
// hash an element: at the conv backward's views (vgg11's block site 1,
// 32768 x 64; resnet18's stage-1 boundary, 131072 x 64) 5.0 us and 20 us
// for f32 x at 3.35 TB/s (3.8 and 15 us bf16), while the hash needs about
// half of that on the integer pipes; at the vgg11_me head (128 x 512)
// 0.16 us, far below a launch, which sets its time. The design, so that
// neither the address arithmetic nor the latency of one load sits in
// front of the bytes: a 2-D mapping (threadIdx.x along a row's pieces, so
// a warp's lanes run along columns, threadIdx.y and the blocks over rows),
// row and column from 32-bit indices with no division, the row's half of
// the hash (row_term) once a row; a piece is 4 consecutive columns, one
// 16-byte (f32) or 8-byte (bf16) load and one 16-byte store, when K is a
// multiple of 4 and both pointers are 16-byte aligned (else a piece is one
// element: the scalar path of the same kernel); each thread loads its next
// piece before it hashes the current one, the first before it reads the
// seeds; and one wave of blocks (the SMs times the blocks an SM holds)
// strides over the rows. Measured on the H100: 8 bf16 a piece (one
// 16-byte load, two 16-byte stores 32 bytes apart) ran 1.4-1.8x slower
// than 4 at every shape, and blocks of 128, 512 or 1024 threads were
// slower at the head than 256, at the views the same.
template <typename T>
struct ApplyVec;

template <>
struct ApplyVec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[N]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};

template <>
struct ApplyVec<__nv_bfloat16> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[N]) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xFFFF0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xFFFF0000u);
  }
};

// V consecutive elements of x from p as f32: a piece, or one element
template <typename T, int V>
__device__ __forceinline__ void apply_load(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = Elem<T>::load(p);
  } else {
    ApplyVec<T>::load(p, v);
  }
}

template <int V>
__device__ __forceinline__ void apply_store(float* p, const float (&o)[V]) {
  if constexpr (V == 1) {
    *p = o[0];
  } else {
    static_assert(V == 4, "a piece is one float4");
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// The rows of one thread: pieces of V columns (V divides K), piece c of
// row r at threadIdx.x + j * blockDim.x, rows threadIdx.y of every block
// in turn; the next piece's load in flight while the current one hashes.
template <typename T, int V>
__device__ __forceinline__ void apply_rows(const T* __restrict__ x,
                                           const int32_t* __restrict__ seeds,
                                           float* __restrict__ out,
                                           uint32_t M, uint32_t K,
                                           uint32_t thresh, float scale,
                                           uint32_t row0) {
  const uint32_t pieces = K / V;
  const uint32_t row_step = gridDim.x * blockDim.y;
  uint32_t r = blockIdx.x * blockDim.y + threadIdx.y;
  uint32_t c = threadIdx.x;
  if (r >= M || c >= pieces) return;
  float v[V];
  apply_load<T, V>(x + static_cast<size_t>(r) * K + c * V, v);
  const uint32_t stream = bayestpu::seed_stream(seeds[0], seeds[1]);
  uint32_t rt = bayestpu::row_term(row0 + r, stream);
  for (;;) {
    uint32_t nr = r, nc = c + blockDim.x;
    if (nc >= pieces) {
      nc = threadIdx.x;
      nr += row_step;
    }
    const bool more = nr < M;
    float nv[V];
    if (more) apply_load<T, V>(x + static_cast<size_t>(nr) * K + nc * V, nv);
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t bits = bayestpu::row_bits(rt, c * V + j);
      o[j] = bits < thresh ? __fmul_rn(v[j], scale) : 0.f;
    }
    apply_store<V>(out + static_cast<size_t>(r) * K + c * V, o);
    if (!more) break;
    if (nr != r) rt = bayestpu::row_term(row0 + nr, stream);
    r = nr;
    c = nc;
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = nv[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(APPLY_THREADS)
    dropout_apply_kernel(const T* __restrict__ x,
                         const int32_t* __restrict__ seeds,
                         float* __restrict__ out, int M, int K,
                         uint32_t thresh, float scale, uint32_t row0,
                         int vec) {
  if (vec) {
    apply_rows<T, ApplyVec<T>::N>(x, seeds, out, M, K, thresh, scale, row0);
  } else {
    apply_rows<T, 1>(x, seeds, out, M, K, thresh, scale, row0);
  }
}

// The launch: block (tx, APPLY_THREADS / tx), tx the least power of two
// that covers a row's pieces (at most APPLY_THREADS); one wave of blocks,
// or fewer when the rows run out first.
template <typename T>
int launch_apply(const void* x, const void* seeds, void* out, int M, int K,
                 uint32_t thresh, float scale, uint32_t row0,
                 cudaStream_t st) {
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, dropout_apply_kernel<T>, APPLY_THREADS, 0);
    return b > 0 ? b : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int V = ApplyVec<T>::N;
  const bool vec = K % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int pieces = vec ? K / V : K;
  int tx = 1;
  while (tx < pieces && tx < APPLY_THREADS) tx *= 2;
  const dim3 block(tx, APPLY_THREADS / tx);
  const long long want = (static_cast<long long>(M) + block.y - 1) / block.y;
  const long long wave = static_cast<long long>(sms) * per_sm;
  const dim3 grid(static_cast<unsigned>(want < wave ? want : wave));
  dropout_apply_kernel<T><<<grid, block, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(seeds),
      static_cast<float*>(out), M, K, thresh, scale, row0, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}


// The float heads on the CUDA cores: the MC heads (row 2, dropout_matmul, at
// one sample; row 3, dropout_matmul_samples) and the Masksembles heads (row
// 9, bank_matmul, at one sample; row 8, bank_matmul_samples), and their
// launches on an x that carries the sample axis (dropout_matmul_xs,
// bank_matmul_xs). Sample s must equal the single kernel (row 2 with
// seeds[s], row 9 with idxs[s]) bit for bit: each pair is this one kernel.
// Each output is ONE chain: acc = 0, then acc = fma(xm_k, w_k, acc) for k
// ascending. No split over blocks, no tensor cores: those would sum in an
// order that depends on the tiling, and TF32 would round an f32 x (and row
// 8's f32 products). What bounds it at the vgg11_me heads (x 128x512, w
// 512x10; S = 10 MC, S = 4 Masksembles, S = 1 rows 2 and 9) is latency, not
// the 6.5 M (2.6 M, 0.65 M) multiply-adds: the loads, w transposes and
// masking of the staging, and the chain of 512 dependent FMAs behind them (4
// interleaved partial chains took at most 2% off when measured, so the chain
// is mostly hidden and stays serial). The design: a block owns 8 rows, 16
// columns and ONE sample (grid (ceil(M/8), ceil(N/16), S): 160 blocks at the
// MC head, 64 at the Masksembles head and 16 for rows 2 and 9, where the
// first port's tile routine launched 8) and is warp-specialised, so that the
// staging runs beside the chains and not before them. Its 4 consumer warps
// own one output a thread. Its 4 producer warps stage a window of K (1 KiB a
// row) in shared memory and hand it over in 4 chunks: at the start they issue
// every load of the window (x by the staging policy, below; w into registers,
// each producer one column at every 8th row, one pointer step a load), then
// per chunk they complete their x piece, masked, once per element for the
// block's one sample, store their w transposed to K-contiguous columns padded
// by 16 bytes, and signal the chunk on a named barrier. The consumers run a
// chunk's FMAs as soon as it is signalled, reading 4 (f32) or 8 (bf16) k of a
// row and of a column per 16-byte load, conflict-free, and holding the next 4
// loads in registers while the current ones' FMAs run, so that neither the
// global nor the shared-memory latency sits inside the chain. A longer K
// takes further windows, each after a block barrier. With x_stride > 0,
// sample s reads x + s * x_stride: exactly what S single launches on x[s]
// compute. Ragged M, N and K are masked here.
constexpr int CH_BM = 8;                        // rows of x and out a block
constexpr int CH_BN = 16;                       // columns of w and out
constexpr int CH_CONSUMERS = CH_BM * CH_BN;     // one output, one chain each
constexpr int CH_PRODUCERS = 128;               // stage, mask, signal
constexpr int CH_THREADS = CH_CONSUMERS + CH_PRODUCERS;
constexpr int CH_WINDOW_BYTES = 1024;           // of a row, staged at once
constexpr int CH_CHUNK_BYTES = 256;             // of a row, signalled at once
constexpr int CH_CHUNKS = CH_WINDOW_BYTES / CH_CHUNK_BYTES;
static_assert(CH_BM * CH_CHUNK_BYTES / 16 == CH_PRODUCERS,
              "one 16-byte x piece a producer and chunk");
static_assert(CH_CHUNKS < 16, "a named barrier a chunk");

template <typename T>
struct Chain {
  static constexpr int KW = CH_WINDOW_BYTES / sizeof(T);   // k of a window
  static constexpr int KCH = CH_CHUNK_BYTES / sizeof(T);   // k of a chunk
  static constexpr int VEC = 16 / sizeof(T);               // k in 16 bytes
  static constexpr int PITCH = KW + VEC;                   // a w column
  static constexpr int ROW_PIECES = KCH / VEC;             // of a chunk row
  static constexpr int W_PER_CHUNK = KCH * CH_BN / CH_PRODUCERS;
};

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Row 2's masked value in x's type: x * scale rounded once to f32, or to
// bf16 (the f32 product of two bf16 values is exact), or 0 if dropped.
__device__ __forceinline__ float masked(float v, bool keep, float scale) {
  return keep ? __fmul_rn(v, scale) : 0.f;
}
__device__ __forceinline__ __nv_bfloat16 masked(__nv_bfloat16 v, bool keep,
                                                float scale) {
  return __float2bfloat16_rn(keep ? __fmul_rn(__bfloat162float(v), scale)
                                  : 0.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's cp.async groups are in
// flight (an immediate in PTX: after unrolling, `pending` is a constant)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
static_assert(CH_CHUNKS <= 4, "cp_async_wait covers 4 chunks in flight");

// Named barrier `id` of `count` threads: the producers arrive, the
// consumers wait; the barrier orders the producers' shared-memory writes
// before the consumers' reads.
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 16 bytes of x and of w: their 4 (f32) or 8 (bf16) terms of a chain, in
// ascending k. A bf16 value widens exactly to the f32 with its bits on top.
__device__ __forceinline__ float fma16(uint4 xv, uint4 wv, float acc, float) {
  const float* xe = reinterpret_cast<const float*>(&xv);
  const float* we = reinterpret_cast<const float*>(&wv);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc = __fmaf_rn(xe[j], we[j], acc);
  return acc;
}
__device__ __forceinline__ float fma16(uint4 xv, uint4 wv, float acc,
                                       __nv_bfloat16) {
  const uint32_t* xe = reinterpret_cast<const uint32_t*>(&xv);
  const uint32_t* we = reinterpret_cast<const uint32_t*>(&wv);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc = __fmaf_rn(__uint_as_float(xe[j] << 16), __uint_as_float(we[j] << 16),
                    acc);
    acc = __fmaf_rn(__uint_as_float(xe[j] & 0xFFFF0000u),
                    __uint_as_float(we[j] & 0xFFFF0000u), acc);
  }
  return acc;
}

// One chunk of a chain: kn (rounded up to VEC, the rest of the chunk is
// zeros in both x and w) terms in ascending k. A whole chunk is read into
// registers in groups of 4 16-byte loads, the next group's loads in flight
// while the current group's FMAs run, so the shared-memory latency stays
// off the chain.
constexpr int CH_GROUP = 4;

template <typename T>
__device__ __forceinline__ float chain_chunk(const T* xr, const T* wc, int kn,
                                             float acc) {
  constexpr int VEC = Chain<T>::VEC;
  constexpr int GROUPS = Chain<T>::KCH / VEC / CH_GROUP;
  const auto* xq = reinterpret_cast<const uint4*>(xr);
  const auto* wq = reinterpret_cast<const uint4*>(wc);
  if (kn == Chain<T>::KCH) {
    uint4 xv[2][CH_GROUP], wv[2][CH_GROUP];
#pragma unroll
    for (int j = 0; j < CH_GROUP; ++j) {
      xv[0][j] = xq[j];
      wv[0][j] = wq[j];
    }
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      if (g + 1 < GROUPS) {
#pragma unroll
        for (int j = 0; j < CH_GROUP; ++j) {
          xv[(g + 1) & 1][j] = xq[(g + 1) * CH_GROUP + j];
          wv[(g + 1) & 1][j] = wq[(g + 1) * CH_GROUP + j];
        }
      }
#pragma unroll
      for (int j = 0; j < CH_GROUP; ++j)
        acc = fma16(xv[g & 1][j], wv[g & 1][j], acc, T());
    }
    return acc;
  }
  for (int q = 0; q * VEC < kn; ++q) acc = fma16(xq[q], wq[q], acc, T());
  return acc;
}

// Staging policies of chain_samples_kernel. TX is x's type as given; T the
// type x is staged in, w is read in and the chain's terms widen from (the
// Chain<T> geometry). `begin(s, xb, K)` takes the block's sample and its x;
// `issue(r, c, dst, xb, gr, gc, M, K)` starts loading the producer's x
// piece of chunk c, Chain<T>::VEC values of row gr from column gc, into
// shared memory at dst or into registers r; `finish(r, c, dst, gr, gc)`
// leaves it at dst, masked, before the chunk is signalled; `drain` ends the
// window.

// MC dropout (rows 2 and 3): x staged in its own type by 16-byte cp.async
// (plain loads where its rows are not 16-byte aligned), then masked in
// place: keep iff coord_bits(row0 + gr, gc + j, stream_s) < thresh, the
// kept value x * scale in x's type.
template <typename TT>
struct HashChain {
  using TX = TT;
  using T = TT;
  static constexpr int VEC = Chain<T>::VEC;
  const int32_t* seeds;  // (S, 2)
  uint32_t thresh;
  float scale;
  uint32_t row0;         // the global row of x's first row
  uint32_t stream;
  bool vec;
  struct Regs {};
  __device__ __forceinline__ void begin(int s, const TX* xb, int K) {
    stream = bayestpu::seed_stream(seeds[2 * s], seeds[2 * s + 1]);
    vec = (static_cast<size_t>(K) * sizeof(T)) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(xb) % 16 == 0;
  }
  __device__ __forceinline__ void issue(Regs&, int, T* dst, const TX* xb,
                                        int gr, int gc, int M, int K) const {
    if (vec) {
      const bool ok = gr < M && gc < K;
      cp_async16(dst, ok ? xb + static_cast<size_t>(gr) * K + gc : xb, ok);
    } else {
      alignas(16) T e[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        e[j] = gr < M && gc + j < K ? xb[static_cast<size_t>(gr) * K + gc + j]
                                    : zero_of<T>();
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(e);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void finish(Regs&, int c, T* piece, int gr,
                                         uint32_t gc) const {
    cp_async_wait(CH_CHUNKS - 1 - c);   // this thread's piece landed
    alignas(16) T e[VEC];
    *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(piece);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      e[j] = masked(e[j],
                    bayestpu::coord_bits(row0 + static_cast<uint32_t>(gr),
                                         gc + j, stream) < thresh,
                    scale);
    *reinterpret_cast<uint4*>(piece) = *reinterpret_cast<uint4*>(e);
  }
  __device__ __forceinline__ void drain() const {
    cp_async_wait(0);   // the zero fills of chunks past K, too
  }
};

// Masksembles (rows 8 and 9): row r = idxs[s] mod n of the f32 bank (n, K)
// (idx0 when idxs is null: one sample), floored as JAX's idx % n takes it
// (-1 -> n - 1). x is loaded in its own type into registers (4 values, 16
// bytes of f32 or 8 of bf16, a load) beside the row's 4 values, then
// widened and staged as __fmul_rn(f32(x), row[k]), the masked value of
// JAX's x_ref * row, in f32 (Chain<float>); w is read as f32. Columns
// beyond K read as 0 in both.
template <typename TT>
struct BankChain {
  using TX = TT;
  using T = float;
  static constexpr int VEC = Chain<float>::VEC;
  // VEC values of x in one load
  using XV = typename std::conditional<sizeof(TX) == 4, uint4, uint2>::type;
  const float* bank;     // (n, K) f32
  const int32_t* idxs;   // (S,), or nullptr
  int idx0;
  int n;
  const float* row;
  bool vec;   // K a multiple of VEC, x and the bank aligned: vector loads
  struct Regs {
    XV x[CH_CHUNKS];
    float4 b[CH_CHUNKS];
  };
  __device__ __forceinline__ void begin(int s, const TX* xb, int K) {
    const int r = (idxs != nullptr ? idxs[s] : idx0) % n;
    row = bank + static_cast<size_t>(r < 0 ? r + n : r) * K;
    vec = K % VEC == 0 && reinterpret_cast<uintptr_t>(xb) % sizeof(XV) == 0 &&
          reinterpret_cast<uintptr_t>(bank) % 16 == 0;
  }
  __device__ __forceinline__ void issue(Regs& r, int c, float*, const TX* xb,
                                        int gr, int gc, int M, int K) const {
    if (vec && gc < K) {   // the whole piece lies inside the row
      r.x[c] = gr < M ? __ldg(reinterpret_cast<const XV*>(
                            xb + static_cast<size_t>(gr) * K + gc))
                      : XV{};
      r.b[c] = __ldg(reinterpret_cast<const float4*>(row + gc));
    } else {
      alignas(16) TX e[VEC];
      alignas(16) float b[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        e[j] = gr < M && gc + j < K ? xb[static_cast<size_t>(gr) * K + gc + j]
                                    : zero_of<TX>();
        b[j] = gc + j < K ? __ldg(row + gc + j) : 0.f;
      }
      r.x[c] = *reinterpret_cast<const XV*>(e);
      r.b[c] = *reinterpret_cast<const float4*>(b);
    }
  }
  __device__ __forceinline__ void finish(Regs& r, int c, float* piece, int,
                                         uint32_t) const {
    alignas(16) TX e[VEC];
    *reinterpret_cast<XV*>(e) = r.x[c];
    const float b[VEC] = {r.b[c].x, r.b[c].y, r.b[c].z, r.b[c].w};
    alignas(16) float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __fmul_rn(widen(e[j]), b[j]);
    *reinterpret_cast<uint4*>(piece) = *reinterpret_cast<const uint4*>(v);
  }
  __device__ __forceinline__ void drain() const {}
};

template <typename Stage>
__global__ void __launch_bounds__(CH_THREADS)
    chain_samples_kernel(const typename Stage::TX* __restrict__ x,
                         const typename Stage::T* __restrict__ w,
                         Stage stage, float* __restrict__ out, int M, int K,
                         int N, int x_stride) {
  using T = typename Stage::T;
  using C = Chain<T>;
  __shared__ __align__(16) T xs[CH_BM][C::KW];
  __shared__ __align__(16) T wt[CH_BN][C::PITCH];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * CH_BM, col0 = blockIdx.y * CH_BN;
  const int s = blockIdx.z;

  if (tid < CH_CONSUMERS) {
    const int tr = tid / CH_BN, tc = tid % CH_BN;
    float acc = 0.f;
    for (int k0 = 0; k0 < K; k0 += C::KW) {
#pragma unroll
      for (int c = 0; c < CH_CHUNKS; ++c) {
        const int kc = k0 + c * C::KCH;
        if (kc < K) {
          bar_sync(1 + c, CH_THREADS);
          acc = chain_chunk(&xs[tr][c * C::KCH], &wt[tc][c * C::KCH],
                            min(C::KCH, K - kc), acc);
        }
      }
      __syncthreads();   // the window read before the producers refill it
    }
    const int gr = row0 + tr, gc = col0 + tc;
    if (gr < M && gc < N)
      out[(static_cast<size_t>(s) * M + gr) * N + gc] = acc;
    return;
  }

  const int p = tid - CH_CONSUMERS;
  const auto* xb = x + static_cast<size_t>(s) * x_stride;
  stage.begin(s, xb, K);
  const T zero = zero_of<T>();
  // this producer's x piece of every chunk: row pr, columns pc .. pc + VEC
  const int pr = p / C::ROW_PIECES, pc = (p % C::ROW_PIECES) * C::VEC;
  const int gr = row0 + pr;
  // and its w: column wn, rows wk + 8 j of every chunk (8 = CH_PRODUCERS /
  // CH_BN), read by one pointer step a load
  constexpr int W_ROWS = CH_PRODUCERS / CH_BN;
  const int wn = p % CH_BN, wk = p / CH_BN;
  const bool w_col = col0 + wn < N;
  const size_t w_step = static_cast<size_t>(W_ROWS) * N;
  for (int k0 = 0; k0 < K; k0 += C::KW) {
    typename Stage::Regs xr;
    T wr[CH_CHUNKS][C::W_PER_CHUNK];
#pragma unroll
    for (int c = 0; c < CH_CHUNKS; ++c)
      stage.issue(xr, c, &xs[pr][c * C::KCH + pc], xb, gr,
                  k0 + c * C::KCH + pc, M, K);
    const T* wq = w + static_cast<size_t>(k0 + wk) * N + col0 + wn;
    const int w_rows = K - (k0 + wk);   // rows of w left below this one
#pragma unroll
    for (int c = 0; c < CH_CHUNKS; ++c) {
#pragma unroll
      for (int j = 0; j < C::W_PER_CHUNK; ++j) {
        wr[c][j] = w_col && c * C::KCH + j * W_ROWS < w_rows ? *wq : zero;
        wq += w_step;
      }
    }
#pragma unroll
    for (int c = 0; c < CH_CHUNKS; ++c) {
      if (k0 + c * C::KCH < K) {
        stage.finish(xr, c, &xs[pr][c * C::KCH + pc], gr,
                     k0 + c * C::KCH + pc);
#pragma unroll
        for (int j = 0; j < C::W_PER_CHUNK; ++j)
          wt[wn][c * C::KCH + wk + j * W_ROWS] = wr[c][j];
        bar_arrive(1 + c, CH_THREADS);
      }
    }
    stage.drain();
    __syncthreads();     // the consumers are done with the window
  }
}

// The int8 heads on the s8 tensor cores, one template over a staging mask
// policy and a K split: the counter hash (row 4, dropout_matmul_int8, one
// sample with K split over a cluster; row 5, dropout_matmul_int8_samples, and
// its launch on an x that carries the sample axis) or a bank row (row 6,
// bank_matmul_int8_samples, and its launch on an x that carries the sample
// axis; row 7, bank_matmul_int8, one sample with K split over a cluster).
// out[s] = f32((x_q * keep_s) @ w_q) * out_scale. A block owns 16 rows of x,
// 8 output columns and ONE sample (grid (ceil(M/16), ceil(N/8), S): 160
// blocks at the vgg11_me MC head, x 128x512, w 512x10, S = 10; 64 at the
// Masksembles head, S = 4, where the first port's tile routine launched 8).
// Per K chunk of KC = 512 / SPLIT bytes it stages the x tile as int8, 16
// bytes a thread, masked once per element as it is staged, and the w tile
// transposed to K-contiguous columns (B fragments), N padded with zeros to 8
// in shared memory; its 4 warps split the chunk's k steps of
// mma.sync.m16n8k32 s8 -> s32 and the 4 partial sums are added in shared
// memory. One sample alone (rows 4 and 7) would launch only 16 blocks at the
// head, each staging all 512 of K in series; so there the SPLIT blocks of one
// output tile form a thread-block cluster along K (grid.z = S * SPLIT,
// cluster (1, 1, SPLIT)): block rank q takes the chunks at q * KC, q * KC +
// 512, ..., and rank 0 adds the others' partial tiles through distributed
// shared memory and writes the epilogue once. The int32 sums are exact in any
// order, so the result equals the plain version and, per sample, the single
// kernels (rows 4 and 7) bit for bit; the epilogue f32(acc) * out_scale runs
// once. Sample s reads x + s * x_stride (0: x is shared).
constexpr int I8_THREADS = 128;
constexpr int I8_BM = 16;                 // rows of x: one m16 tile
constexpr int I8_BN = 8;                  // columns of w: one n8 tile
constexpr int I8_KC = 512;                // bytes of K a split covers at once
// the K split of rows 4 and 7: the fastest of 1, 2 and 4 for row 7 at the
// Masksembles head, as measured once (PERF.md's kernel table has all three
// times)
constexpr int I8_SPLIT = 4;

// A staging policy: `begin` takes the block's sample, `apply` zeroes the
// dropped bytes among 16 staged x bytes at row gr, columns gc .. gc + 15.
// MC dropout: keep iff coord_bits(row0 + gr, gc + j, stream_s) < thresh.
struct HashStage {
  const int32_t* seeds;  // (S, 2)
  uint32_t thresh;
  uint32_t row0;         // the global row of x's first row
  uint32_t stream;
  __device__ __forceinline__ void begin(int s) {
    stream = bayestpu::seed_stream(seeds[2 * s], seeds[2 * s + 1]);
  }
  __device__ __forceinline__ void apply(int8_t (&e)[16], int gr,
                                        int gc) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t bits = bayestpu::coord_bits(
          row0 + static_cast<uint32_t>(gr), static_cast<uint32_t>(gc + j),
          stream);
      if (bits >= thresh) e[j] = 0;
    }
  }
};

// Masksembles: keep iff bank[r][k] > 0.5 with r = idxs[s] mod n (idx0 when
// idxs is null: one sample), floored as BankChain::begin and JAX's idx % n
// take it (-1 -> n - 1); k >= K reads as dropped. The 16 floats of the row
// are read beside the 16 x bytes.
struct BankStage {
  const float* bank;     // (n, K) f32
  const int32_t* idxs;   // (S,), or nullptr
  int idx0;
  int n;
  int K;
  const float* row;
  __device__ __forceinline__ void begin(int s) {
    const int r = (idxs != nullptr ? idxs[s] : idx0) % n;
    row = bank + static_cast<size_t>(r < 0 ? r + n : r) * K;
  }
  __device__ __forceinline__ void apply(int8_t (&e)[16], int, int gc) const {
    float b[16];
    if (gc + 16 <= K && K % 4 == 0 &&
        reinterpret_cast<uintptr_t>(bank) % 16 == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + gc) + q);
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) b[j] = gc + j < K ? __ldg(row + gc + j) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (!(b[j] > 0.5f)) e[j] = 0;
  }
};

template <typename Stage, int SPLIT>
__global__ void __launch_bounds__(I8_THREADS)
    int8_samples_mma_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ w, Stage stage,
                            float* __restrict__ out, int M, int K, int N,
                            int x_stride, float out_scale) {
  constexpr int KC = I8_KC / SPLIT;       // bytes of K staged at a time
  constexpr int PITCH = KC + 16;          // conflict-free 4-byte reads
  static_assert(KC % 32 == 0, "whole m16n8k32 k steps");
  __shared__ __align__(16) int8_t xs[I8_BM][PITCH];
  __shared__ __align__(16) int8_t wt[I8_BN][PITCH];
  __shared__ int32_t red[I8_THREADS / 32][I8_BM * I8_BN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * I8_BM, col0 = blockIdx.y * I8_BN;
  const int s = blockIdx.z / SPLIT;
  int rank = 0;                           // of the block in its cluster
  if constexpr (SPLIT > 1)
    rank = static_cast<int>(cg::this_cluster().block_rank());
  stage.begin(s);
  const int8_t* xb = x + static_cast<size_t>(s) * x_stride;
  const bool vec =
      K % 16 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0;
  const int g = lane >> 2, t4 = lane & 3;
  int32_t acc[4] = {0, 0, 0, 0};
  for (int k0 = rank * KC; k0 < K; k0 += SPLIT * KC) {
    for (int i = tid; i < I8_BM * (KC / 16); i += I8_THREADS) {
      const int r = i / (KC / 16), c = (i % (KC / 16)) * 16;
      const int gr = row0 + r, gc = k0 + c;
      alignas(16) int8_t e[16];
      if (gr < M && gc < K && vec) {
        *reinterpret_cast<uint4*>(e) = __ldg(reinterpret_cast<const uint4*>(
            xb + static_cast<size_t>(gr) * K + gc));
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          e[j] = gr < M && gc + j < K
                     ? xb[static_cast<size_t>(gr) * K + gc + j]
                     : int8_t(0);
      }
      stage.apply(e, gr, gc);
      *reinterpret_cast<uint4*>(&xs[r][c]) = *reinterpret_cast<uint4*>(e);
    }
    for (int i = tid; i < I8_BN * KC; i += I8_THREADS) {
      const int kk = i / I8_BN, n = i % I8_BN;
      const int gk = k0 + kk, gn = col0 + n;
      wt[n][kk] = gk < K && gn < N ? w[static_cast<size_t>(gk) * N + gn]
                                   : int8_t(0);
    }
    __syncthreads();
    for (int kb = warp * 32; kb < KC; kb += 32 * (I8_THREADS / 32)) {
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
  if constexpr (SPLIT > 1) {
    // the block's partial tile in red[0] (each thread rewrites the entry
    // it alone read), then rank 0 adds the other ranks' tiles
    cg::cluster_group cluster = cg::this_cluster();
    red[0][tid] = sum;
    cluster.sync();        // every rank's partial tile is written
    if (rank == 0) {
#pragma unroll
      for (int q = 1; q < SPLIT; ++q)
        sum += cluster.map_shared_rank(&red[0][0], q)[tid];
    }
    cluster.sync();        // rank 0 has read them before any rank exits
    if (rank != 0) return;
  }
  const int gr = row0 + r, gc = col0 + c;
  if (gr < M && gc < N)
    out[(static_cast<size_t>(s) * M + gr) * N + gc] =
        Elem<int8_t>::out(sum, out_scale);
}

// Launch int8_samples_mma_kernel<Stage, SPLIT> on grid (tiles of M, tiles
// of N, S): with SPLIT > 1, SPLIT blocks a tile and sample, one cluster.
template <int SPLIT, typename Stage>
int launch_int8_mma(dim3 grid, cudaStream_t st, const void* x, const void* w,
                    Stage stage, void* out, int M, int K, int N, int x_stride,
                    float out_scale) {
  const auto* xq = static_cast<const int8_t*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  auto* o = static_cast<float*>(out);
  if constexpr (SPLIT == 1) {
    int8_samples_mma_kernel<Stage, 1><<<grid, I8_THREADS, 0, st>>>(
        xq, wq, stage, o, M, K, N, x_stride, out_scale);
    return static_cast<int>(cudaGetLastError());
  } else {
    grid.z *= SPLIT;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = SPLIT;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(I8_THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, int8_samples_mma_kernel<Stage, SPLIT>, xq,
                           wq, stage, o, M, K, N, x_stride, out_scale);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
}

// Launch chain_samples_kernel<BankChain<T>> (T from is_bf16) on grid
// (tiles of M, tiles of N, S): rows 9 (S = 1, idxs null, row idx0), 8
// and 8x.
int launch_bank_chain(const void* x, const void* w, const void* bank,
                      const void* idxs, int idx0, void* out, int M, int K,
                      int N, int S, int x_stride, int n, int is_bf16,
                      cudaStream_t st) {
  const dim3 grid((M + CH_BM - 1) / CH_BM, (N + CH_BN - 1) / CH_BN, S);
  const auto* b = static_cast<const float*>(bank);
  const auto* ix = static_cast<const int32_t*>(idxs);
  const auto* wf = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  if (is_bf16) {
    using Stage = BankChain<__nv_bfloat16>;
    chain_samples_kernel<Stage><<<grid, CH_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wf,
        Stage{b, ix, idx0, n, nullptr, false}, o, M, K, N, x_stride);
  } else {
    using Stage = BankChain<float>;
    chain_samples_kernel<Stage><<<grid, CH_THREADS, 0, st>>>(
        static_cast<const float*>(x), wf,
        Stage{b, ix, idx0, n, nullptr, false}, o, M, K, N, x_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch chain_samples_kernel<HashChain<T>> (T from is_bf16) on grid
// (tiles of M, tiles of N, S): rows 2 (S = 1), 3 and 3x.
int launch_hash_chain(const void* x, const void* w, const void* seeds,
                      void* out, int M, int K, int N, int S, int x_stride,
                      uint32_t thresh, float scale, int is_bf16,
                      uint32_t row0, cudaStream_t st) {
  const dim3 grid((M + CH_BM - 1) / CH_BM, (N + CH_BN - 1) / CH_BN, S);
  const auto* sd = static_cast<const int32_t*>(seeds);
  auto* o = static_cast<float*>(out);
  if (is_bf16) {
    using Stage = HashChain<__nv_bfloat16>;
    chain_samples_kernel<Stage><<<grid, CH_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        Stage{sd, thresh, scale, row0, 0u, false}, o, M, K, N, x_stride);
  } else {
    using Stage = HashChain<float>;
    chain_samples_kernel<Stage><<<grid, CH_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        Stage{sd, thresh, scale, row0, 0u, false}, o, M, K, N, x_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success); it neither allocates nor synchronises. The MC entries
// take row0, the global row of x's first row (of each sample's x): row r
// of x is hashed as row row0 + r, uint32 with wraparound, so a launch on
// rows [r0, r0 + M) of a batch masks them as the launch on the whole batch
// does (0: x is the whole batch).
// seeds: one (1, 2) pair; row 3's kernel at one sample
extern "C" int bt_dropout_matmul(const void* x, const void* w,
                                 const void* seeds, void* out, int M, int K,
                                 int N, uint32_t thresh, float scale,
                                 int is_bf16, uint32_t row0, void* stream) {
  return launch_hash_chain(x, w, seeds, out, M, K, N, 1, 0, thresh, scale,
                           is_bf16, row0, static_cast<cudaStream_t>(stream));
}

// x_stride: elements between samples' x, 0 when x is shared (row 3), M * K
// when x carries the sample axis (dropout_matmul_xs)
extern "C" int bt_dropout_matmul_samples(const void* x, const void* w,
                                         const void* seeds, void* out, int M,
                                         int K, int N, int S, int x_stride,
                                         uint32_t thresh, float scale,
                                         int is_bf16, uint32_t row0,
                                         void* stream) {
  return launch_hash_chain(x, w, seeds, out, M, K, N, S, x_stride, thresh,
                           scale, is_bf16, row0,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int bt_dropout_apply(const void* x, const void* seeds, void* out,
                                int M, int K, uint32_t thresh, float scale,
                                int is_bf16, uint32_t row0, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_apply<__nv_bfloat16>(x, seeds, out, M, K, thresh,
                                               scale, row0, st)
                 : launch_apply<float>(x, seeds, out, M, K, thresh, scale,
                                       row0, st);
}

// seeds: one (1, 2) pair; row 5's kernel at one sample, K split over a
// cluster of I8_SPLIT blocks
extern "C" int bt_dropout_matmul_int8(const void* x, const void* w,
                                      const void* seeds, void* out, int M,
                                      int K, int N, uint32_t thresh,
                                      float out_scale, uint32_t row0,
                                      void* stream) {
  const dim3 grid((M + I8_BM - 1) / I8_BM, (N + I8_BN - 1) / I8_BN, 1);
  return launch_int8_mma<I8_SPLIT>(
      grid, static_cast<cudaStream_t>(stream), x, w,
      HashStage{static_cast<const int32_t*>(seeds), thresh, row0, 0u}, out,
      M, K, N, 0, out_scale);
}

// x_stride: elements between samples' x, 0 when x is shared (row 5), M * K
// when x carries the sample axis (dropout_matmul_int8_xs)
extern "C" int bt_dropout_matmul_int8_samples(const void* x, const void* w,
                                              const void* seeds, void* out,
                                              int M, int K, int N, int S,
                                              int x_stride, uint32_t thresh,
                                              float out_scale, uint32_t row0,
                                              void* stream) {
  const dim3 grid((M + I8_BM - 1) / I8_BM, (N + I8_BN - 1) / I8_BN, S);
  return launch_int8_mma<1>(
      grid, static_cast<cudaStream_t>(stream), x, w,
      HashStage{static_cast<const int32_t*>(seeds), thresh, row0, 0u}, out,
      M, K, N, x_stride, out_scale);
}

// row 8's kernel at one sample, bank row idx (no index copied to the card)
extern "C" int bt_bank_matmul(const void* x, const void* w, const void* bank,
                              void* out, int M, int K, int N, int idx,
                              int n, int is_bf16, void* stream) {
  return launch_bank_chain(x, w, bank, nullptr, idx, out, M, K, N, 1, 0, n,
                           is_bf16, static_cast<cudaStream_t>(stream));
}

// x_stride: elements between samples' x, 0 when x is shared (row 8), M * K
// when x carries the sample axis (bank_matmul_xs)
extern "C" int bt_bank_matmul_samples(const void* x, const void* w,
                                      const void* bank, const void* idxs,
                                      void* out, int M, int K, int N, int S,
                                      int x_stride, int n, int is_bf16,
                                      void* stream) {
  return launch_bank_chain(x, w, bank, idxs, 0, out, M, K, N, S, x_stride, n,
                           is_bf16, static_cast<cudaStream_t>(stream));
}

extern "C" int bt_bank_matmul_int8(const void* x, const void* w,
                                   const void* bank, void* out, int M, int K,
                                   int N, int idx, int n, float out_scale,
                                   void* stream) {
  const dim3 grid((M + I8_BM - 1) / I8_BM, (N + I8_BN - 1) / I8_BN, 1);
  return launch_int8_mma<I8_SPLIT>(
      grid, static_cast<cudaStream_t>(stream), x, w,
      BankStage{static_cast<const float*>(bank), nullptr, idx, n, K, nullptr},
      out, M, K, N, 0, out_scale);
}

// x_stride: elements between samples' x, 0 when x is shared (row 6), M * K
// when x carries the sample axis (bank_matmul_int8_xs)
extern "C" int bt_bank_matmul_int8_samples(const void* x, const void* w,
                                           const void* bank, const void* idxs,
                                           void* out, int M, int K, int N,
                                           int S, int x_stride, int n,
                                           float out_scale, void* stream) {
  const dim3 grid((M + I8_BM - 1) / I8_BM, (N + I8_BN - 1) / I8_BN, S);
  return launch_int8_mma<1>(
      grid, static_cast<cudaStream_t>(stream), x, w,
      BankStage{static_cast<const float*>(bank),
                static_cast<const int32_t*>(idxs), 0, n, K, nullptr},
      out, M, K, N, x_stride, out_scale);
}
