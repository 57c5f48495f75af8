// Masked convolutions with a fused epilogue for Hopper (sm_90a), plain C
// interface.
//
// Replaces the two Pallas TPU kernels of bayestpu/kernels/masked_conv.py
// with three routines: conv_mma_kernel_1x1<Mask> for a bf16 MC conv with a
// 1x1 window and window::conv_mma_kernel<Mask> for one with a 3x3 window
// at stride 2 (both below), and conv_mma_kernel<TX, TS, Mask> (x of type
// TX, staged and multiplied as TS), an implicit GEMM on the tensor cores,
// for every other conv:
//   <T, T, HashMask|NoMask>      <- _masked_conv_kernel (:371-417),
//   <TX, float, HashMask|NoMask>    launched by _launch_masked (:473-510):
//        dropout_conv, dropout_conv_samples, dropout_conv_inference (x
//        carrying the sample axis included) and conv_fused, bf16 x with
//        bf16 w in bf16, any f32 operand in f32 (three TF32 products); the
//        int8 twins dropout_conv_int8{,_samples}, conv_int8_fused in int8.
//   <TX, float, BankMask>        <- _bank_conv_kernel (:430-467),
//   <int8_t, int8_t, BankMask>      launched by _launch_bank (:513-560):
//        bank_conv{,_samples} (TX bf16 or f32; three TF32 products) and
//        bank_conv_int8{,_samples}, and both on an x that carries the
//        sample axis (the _xs entries; JAX's lax.map of the single kernel,
//        :845-851 and :1070-1076).
// Each computes, for every sample s, out[s] = epilogue(conv(x_s ⊙ mask_s,
// w)) with x NHWC (N, H, W, C), out (S, N, Ho, Wo, F), stride 1 or 2 and
// any zero padding (the caller resolves XLA's SAME, VALID or explicit pairs
// into the top and left pads; the bottom and right ones follow from Ho and
// Wo). x_s is x itself (one x for all samples) or, in the _xs entries, the
// s-th of S inputs (S, N, H, W, C), as JAX's vmap over (x, seeds) maps the
// single kernel. The mask of x_s element (n, h, w, c):
//   - HashMask: the counter hash of prng.cuh on the sample's own, unpadded
//     coordinate (row0 + n·H·W + h·W + w, c) with seeds[s], i.e. the bits
//     dropout_apply gives x_s viewed as (N·H·W, C) at the same row0 (dims
//     [13]: b0·H·W, uint32, for x the rows from global image b0 on; 0 for
//     the whole batch); a kept float value is
//     multiplied by the dropout scale and rounded to x's type (bf16: scale
//     1.3359375 at rate 0.25, as JAX's weak-typed constant), an int8 one
//     kept as it is (1/keep folds into out_scale);
//   - BankMask: row idxs[s] mod n (floor) of the f32 (n, C) bank; the float
//     kernels multiply x, widened to f32, by the row's value, clipped at 0
//     when n > 1 (JAX selects the row as a max over a where, which clips a
//     negative entry to 0); the int8 kernels keep x where the value > 0.5;
//   - NoMask: x as it is (conv_fused, conv_int8_fused).
// Products accumulate in f32 (float kernels; bf16 products are exact, f32
// ones come to about 2^-22 of each from three TF32 ones) or int32 (int8 x
// int8, exact). The epilogue (affine_of, epi_y, store_y), in f32 and in
// _epi_apply's order, with the roundings that the
// JAX kernel has on XLA's CPU backend (the reference the tests hold the
// port to; measured there on every element): with the (2, F) affine, y =
// fma(acc, scale[f], bias[f]) for the float kernels and y = fma(f32(acc),
// f32(out_scale * scale[f]), bias[f]) for the int8 ones (XLA contracts
// JAX's y * scale + bias into one fused multiply-add and folds the constant
// out_scale, the f32 of x_step·w_step [/(1 - rate)], into the scale row);
// without it, y = acc or f32(acc) * out_scale; relu when asked; then store
// f32, bf16 (round to nearest even) or int8 = clip(trunc(s ± 0.5), -128,
// 127) with s = y * inv_step. Every other multiply and add is written
// __fmul_rn / __fadd_rn, so nvcc contracts nothing else and an int8 output
// equals JAX's bit for bit.
//
// What bounds it on an H100: at the block-site vgg11 shapes (x 128x16x16x64
// -> 128, 128x8x8x128 -> 256, 128x4x4x256 -> 512, 128x2x2x512 -> 512, 3x3)
// one sample at site 1 is 4.44 GFLOP of products that read an input element
// against 2-5 MB of bf16 traffic: operations bound, 0.0045 ms at the 989
// TFLOP/s of bf16 tensor cores (half that at the 1,979 TOP/s of int8); an
// f32 route's three TF32 products 0.027 ms at 495 TFLOP/s, where f32
// multiply-adds outside the tensor cores would take 0.066 ms at 67.
//
// The tensor-core routine (conv_mma_kernel) is an implicit GEMM: M = output
// pixels, N = F, K = KH·KW·C, in the order (channel chunk, tap, channel). A
// block owns 64 output pixels (NB images x TH rows x TW columns) by 128
// output channels of ONE sample (grid.z is the sample); its eight warps each
// own 32 x 32 of that tile as 2 x 4 mma.sync tiles (m16n8k16 bf16 -> f32,
// m16n8k32 s8 -> s32, three m16n8k8 tf32 -> f32). K walks C in chunks of 32
// bytes of the staged type (16 bf16, 32 int8 or 8 f32 channels, one mma k
// step per tap). Per chunk the block stages the input patch its pixels read
// (halo included), masked ONCE per element as it is staged, so every tap
// reads the masked value from there and the mask runs once per staged
// element; the raw x of the next chunk is loaded into registers, in x's own
// type, while this chunk's products run. The staged type is bf16 for an MC
// conv of bf16 x and w, int8 for the int8 convs, and f32 for every other
// float conv (the f32 route): the masked value as JAX forms it (an MC x
// times the scale rounded to x's type, a bank x __fmul_rn(f32(x), b)),
// widened exactly. The weights come from the (KH·KW, F, Cp) copy the
// wrapper builds (K contiguous, C zero-padded to Cp, a multiple of 32 bytes,
// in the staged type: a bf16 w widened exactly) by cp.async,
// double-buffered over the chunks (in groups of up to 9 taps, so a larger
// window streams too). Fragments come from shared memory by ldmatrix; the
// 32-byte rows are XOR-swizzled, conflict-free. ldmatrix's b16 matrices hand
// a lane the 32-bit word (row lane/4, word lane%4) of an 8 x 4-word matrix,
// which is also the tf32 A and B fragment, so one addressing serves every
// type. A tf32 fragment is split in registers into big = tf32(v) and small =
// tf32(v - big), and the tensor core runs small·big, big·small and big·big:
// about 22 bits of each f32 product (CUTLASS's 3xTF32), where one TF32
// product keeps 11. Float sums run in two levels: each chunk's taps on the
// tensor core from zero, then that partial added to the f32 total with one
// rounding, so a sum of K terms rounds like an f32 sum and not like a long
// tensor-core chain. On the f32 route that total lives in shared memory (32
// KiB a block), since the split fragments leave it no room in the 128
// registers of two blocks an SM, and a thread reads the bank row of its
// channels once a chunk. Every launch kind of one shape runs this routine
// with one tile and one K order, so sample s of a samples or _xs launch
// equals the single launch with seeds[s] or idxs[s] bit for bit. 128 channels
// a block, not 64, halve the masking, which every channel tile repeats for
// its pixels.
//
// A block's patch holds at most MAX_PATCH_ROWS positions; a window and
// stride whose 8 x 8 tile needs more (7 x 7 at stride 2: 21 x 21) take a
// smaller tile of the same routine (make_mma_geom).
//
// The 1x1 routine (conv_mma_kernel_1x1). launch_mma sends it an MC conv
// (HashMask) of bf16 x and w with a 1x1 window, no padding, stride 1 or 2
// (at stride 2 H even and at most 64 output columns), C a multiple of 8 and
// at most 1,024, and x 16-byte aligned (takes_1x1); the shape and the types
// decide, never S or the launch kind, so every launch kind of one shape runs
// one tile and one K order. A mask-free bf16 conv (conv_fused, NoMask) keeps
// the implicit GEMM: no model path runs one at 1x1. Such a conv is a GEMM (M
// = output pixels, K = C, N = F) whose output row reads one input pixel, (n,
// oh·st, ow·st): no halo at stride 2. Where the implicit GEMM re-stages and
// re-hashes its pixels' input for every 128-channel tile of F (and its 15 x
// 15 patches at stride 2 hold 3.5x the pixels read), this routine masks each
// element it reads once a sample, whatever F is: an item of 64 output pixels
// (at stride 2, R = 64 / Wo whole output rows) of one sample keeps its whole
// K, masked, in shared memory (A, up to 128 KiB) while the F tiles walk over
// it. Persistent blocks (one an SM, clusters of 4) split the work by warp
// role: a producer warp streams the weights' 64-channel k chunks through a
// ring of up to 8 stages by TMA, each load multicast to the 4 blocks of a
// cluster (a weight byte leaves L2 once for 4 items); two stager warpgroups
// fetch each item's A by TMA (128-byte swizzled, as wgmma reads it) into one
// of up to 3 buffers, one item ahead, and mask it in place (the factored
// hash of prng.cuh, 13 integer operations an element); two consumer
// warpgroups run wgmma m64n64k16 from shared memory, 64 channels of F each,
// with the same two-level sum (a 64-channel chunk from zero on the tensor
// core, then added to the f32 total), and the epilogue above. The S items of
// one pixel tile are neighbours in the schedule, so a shared x is read from
// memory about once. What bounds it at resnet50's six block-site convs
// (batch 128, S = 10, 263 GFLOP each, 0.27 ms at the bf16 peak; 1.95 ms for
// the six by bytes, the S bf16 outputs): the integer issue of the hash, 2.25
// G evaluations, ~1.3 ms at stage 2's convbn1 alone, and the tensor pipe
// drained after each chunk, where the two-level sum reads the partial.
//
// The window routine (window::conv_mma_kernel). launch_mma sends it an MC
// conv (HashMask) of bf16 x and w with a 3x3 window at stride 2, a top and
// a left pad of 0 or 1 (XLA's SAME, torch's padding=1), C a multiple of 64
// and at most 1,024, at most 127 output columns and x 16-byte aligned
// (takes_window); the shape and the types decide, never S or the launch
// kind. Where conv_mma_kernel stages a 17 x 17 patch for each 8 x 8 output
// tile and masks it again for each 128-channel tile of F, this routine
// masks each input element once a sample (and again only in the halo row
// two items share): an item of R whole output rows of one sample (R from
// the shape alone, window_plan: 4, 4 and 8 at resnet18's ImageNet sites)
// stages its band of input rows (all of C, zeros outside the image, by TMA
// at a column stride of 2, so each tap reads its columns in a row) and the
// stagers mask it in place while the consumers run every F tile over it:
// wgmma m64n64k16 with A from the band by ldmatrix into registers (the
// stride-2 gather and the tap offsets in the lanes' addresses) and B from
// a ring of 16 KiB stages (64 channels of one tap, 128 output channels)
// that a producer warp fills by TMA, multicast over clusters of 4; the
// same two-level sum, a chunk's 9 taps of 64 channels from zero, then
// added to the f32 total; the epilogue above. 128 registers a thread (16
// warps) hold a consumer's sum, total and one group's A fragments, so a
// warpgroup keeps one group of two k steps in flight and the two consumer
// warpgroups take turns on the tensor core. What bounds it at resnet18's
// three site convs (batch 128, S = 10, 148 GFLOP each, 0.150 ms at the
// bf16 peak; 0.926, 0.729 and 0.734 ms measured): at stage 2 (C = 64) the
// hash's integer issue, 284 M evaluations on six stager warps, busy ~3/4
// of the launch; at stages 3 and 4 the products, a weight stage feeding
// 64 output rows (64 operations a weight byte; a block's ring delivers
// about 16 KiB a 330 ns, 0.35 and 0.47 ms of ring time alone), and at
// stage 4 the refill of its one band (144 KiB: two do not fit) between
// items.
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include "prng.cuh"

namespace {

constexpr int MAX_SMEM = 200 * 1024;

// the tensor-core routine
constexpr int MMA_THREADS = 256;  // 8 warps, 2 x 4 over the 64 x 128 tile
constexpr int MMA_BN = 128;       // output channels of a block
constexpr int KB = 32;            // bytes of one mma k step, of a chunk and
                                  // of a staged row
constexpr int TAP_GROUP = 9;      // taps of weights staged at a time
constexpr int MAXV = 3;           // patch vectors of a thread, at most
constexpr int MMA_BM = 64;        // output pixels of a block, at most
// staged patch rows (two vectors each) of a block, at most
constexpr int MAX_PATCH_ROWS = MAXV * MMA_THREADS / 2;
// the f32 total of a thread's 2 x 4 tiles, in shared memory on the f32
// (three-pass TF32) route: 32 KiB a block
constexpr int TOTAL_BYTES = 2 * 4 * 4 * MMA_THREADS * 4;

enum OutKind { OUT_F32 = 0, OUT_BF16 = 1, OUT_INT8 = 2 };

// V: the type an element is masked in (f32 for the float types, int32 for
// int8); load and widen widen exactly, narrow rounds a V to T (exactly
// when it holds a value of T).
template <typename T>
struct Ld;
template <>
struct Ld<float> {
  using V = float;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
};
template <>
struct Ld<__nv_bfloat16> {
  using V = float;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <>
struct Ld<int8_t> {
  using V = int32_t;
  static __device__ __forceinline__ int32_t load(const int8_t* p) {
    return *p;
  }
  static __device__ __forceinline__ int32_t widen(int8_t v) { return v; }
  static __device__ __forceinline__ int8_t narrow(int32_t v) {
    return static_cast<int8_t>(v);
  }
};

// x * scale as the JAX kernel rounds it: to f32 for an f32 x, to bf16 for a
// bf16 x (the f32 product of two bf16 values is exact); int8 is kept as it
// is.
template <typename T>
__device__ __forceinline__ typename Ld<T>::V keep_scaled(
    typename Ld<T>::V v, float s) {
  if constexpr (std::is_same<T, float>::value) {
    return __fmul_rn(v, s);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, s)));
  } else {
    return v;
  }
}

// Mask policies: `begin` sets a block up for its sample, `apply` masks one
// staged x value given its row in the sample (n·H·W + h·W + w) and channel.
// The tensor-core routine masks through `channels<VE>(c, C)`, the policy's
// view of VE channels c .. c + VE - 1 (all of one thread's patch vectors
// of a chunk share them): its apply(row, j, v) masks channel c + j. The
// per-element policies forward to their own apply (PerElement); a bank row
// is read there once a chunk (BankChannels).
template <typename Mask>
struct PerElement {
  Mask m;
  int c;
  __device__ __forceinline__ typename Mask::V apply(
      uint32_t row, int j, typename Mask::V v) const {
    return m.apply(row, c + j, v);
  }
};

template <typename TX>
struct NoMask {
  using V = typename Ld<TX>::V;
  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ V apply(uint32_t, int, V v) const { return v; }
  template <int VE>
  __device__ __forceinline__ PerElement<NoMask> channels(int c, int) const {
    return {*this, c};
  }
};

template <typename TX>
struct HashMask {
  using V = typename Ld<TX>::V;
  const int32_t* seeds;  // (S, 2)
  uint32_t thresh;
  float scale;
  uint32_t row0;         // the hash row of x's first pixel: b0·H·W
  uint32_t stream;
  __device__ __forceinline__ void begin(int s) {
    stream = bayestpu::seed_stream(seeds[2 * s], seeds[2 * s + 1]);
  }
  // the row's key of the factored hash (prng.cuh), for the 1x1 routine
  __device__ __forceinline__ uint32_t row_key(uint32_t row) const {
    return bayestpu::row_key(bayestpu::row_term(row0 + row, stream));
  }
  __device__ __forceinline__ V apply(uint32_t row, int c, V v) const {
    const uint32_t bits =
        bayestpu::coord_bits(row0 + row, static_cast<uint32_t>(c), stream);
    return bits < thresh ? keep_scaled<TX>(v, scale) : V(0);
  }
  template <int VE>
  __device__ __forceinline__ PerElement<HashMask> channels(int c,
                                                           int) const {
    return {*this, c};
  }
};

// VE channels of a bank row: the float kernels' multipliers (the row's
// values, a negative one clipped to 0 when n > 1), or the int8 kernels'
// keep bits (value > 0.5); channels at or past C read as 0 (dropped).
template <typename TX, int VE>
struct BankChannels {
  using V = typename Ld<TX>::V;
  float b[VE];
  uint32_t keep;
  __device__ __forceinline__ V apply(uint32_t, int j, V v) const {
    if constexpr (std::is_same<V, float>::value) {
      return __fmul_rn(v, b[j]);
    } else {
      return (keep >> j) & 1u ? v : V(0);
    }
  }
};

template <typename TX>
struct BankMask {
  using V = typename Ld<TX>::V;
  const float* bank;     // (n, C) f32
  const int32_t* idxs;   // (S,) any int32; nullptr: every sample is idx0
  int idx0;
  int n;
  int C;
  const float* row;
  __device__ __forceinline__ void begin(int s) {
    int r = (idxs != nullptr ? idxs[s] : idx0) % n;
    if (r < 0) r += n;
    row = bank + static_cast<size_t>(r) * C;
  }
  template <int VE>
  __device__ __forceinline__ BankChannels<TX, VE> channels(int c,
                                                           int C) const {
    BankChannels<TX, VE> m{};
#pragma unroll
    for (int j = 0; j < VE; ++j) {
      const float b = c + j < C ? __ldg(row + c + j) : 0.f;
      m.b[j] = (n > 1 && !(b > 0.f)) ? 0.f : b;
      if (b > 0.5f) m.keep |= 1u << j;
    }
    return m;
  }
};

struct Geom {
  int N, H, W, C, F, KH, KW, st, pt, pl, Ho, Wo, S;
  int TH, TW, NB, PH, PW;      // tile: NB images x TH x TW outputs
  int tiles_h, tiles_w;
  long long xstride;           // elements from x_s to x_{s+1}; 0: shared x
};

struct Epi {
  const float* affine;  // (2, F) [scale; bias] or nullptr
  int out_kind;
  int relu;
  float inv_step;
  float out_scale;      // int8 accumulators only
};

template <typename V>
__device__ __forceinline__ float acc_to_f32(V a, float out_scale) {
  if constexpr (std::is_same<V, float>::value) {
    return a;
  } else {
    return __fmul_rn(__int2float_rn(a), out_scale);
  }
}

// The epilogue in three steps: the affine row of output channel f (scale,
// with out_scale folded in for int8 accumulators, and bias); y of one
// accumulator; its store at out[i].
template <typename V>
__device__ __forceinline__ void affine_of(const Epi& e, int F, int f,
                                          float* sc, float* bi) {
  if (e.affine == nullptr) return;
  *sc = e.affine[f];
  if constexpr (!std::is_same<V, float>::value) {
    *sc = __fmul_rn(e.out_scale, *sc);   // int8: out_scale folds in
  }
  *bi = e.affine[F + f];
}

template <typename V>
__device__ __forceinline__ float epi_y(const Epi& e, V acc, float sc,
                                       float bi) {
  float y = e.affine != nullptr ? __fmaf_rn(acc_to_f32(acc, 1.f), sc, bi)
                                : acc_to_f32(acc, e.out_scale);
  if (e.relu) y = y > 0.f ? y : 0.f;
  return y;
}

__device__ __forceinline__ int8_t int8_of(const Epi& e, float y) {
  const float sc = __fmul_rn(y, e.inv_step);
  float r = truncf(__fadd_rn(sc, sc >= 0.f ? 0.5f : -0.5f));
  r = fminf(fmaxf(r, -128.f), 127.f);
  return static_cast<int8_t>(r);
}

__device__ __forceinline__ void store_y(const Epi& e, float y, size_t i,
                                        void* out) {
  if (e.out_kind == OUT_F32) {
    static_cast<float*>(out)[i] = y;
  } else if (e.out_kind == OUT_BF16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  } else {
    static_cast<int8_t*>(out)[i] = int8_of(e, y);
  }
}

// out[i] = y0 and out[i + 1] = y1 in one store; i must be even
__device__ __forceinline__ void store_y2(const Epi& e, float y0, float y1,
                                         size_t i, void* out) {
  if (e.out_kind == OUT_F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
        make_float2(y0, y1);
  } else if (e.out_kind == OUT_BF16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       i) = __floats2bfloat162_rn(y0, y1);
  } else {
    *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + i) =
        make_char2(int8_of(e, y0), int8_of(e, y1));
  }
}

// ------------------------------------------------- the tensor-core routine

template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
};
template <>
struct Mma<int8_t> {
  using Acc = int32_t;
  static __device__ __forceinline__ void run(int32_t (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
    return a + b;
  }
};
// f32 operands: m16n8k8 tf32, run three times a k step on the two halves of
// each operand (mma_step)
template <>
struct Mma<float> {
  using Acc = float;
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
};

// v rounded to tf32 (10 stored mantissa bits, to nearest, ties away from
// zero), as an f32 whose low 13 bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xFFFFE000u;
}

// The f32 in v (its bits) becomes big = tf32(v); returns small = tf32(v -
// big). v - big is exact in f32, so big + small is v to about 2^-22 of it.
__device__ __forceinline__ uint32_t split_tf32(uint32_t& v) {
  const float f = __uint_as_float(v);
  v = tf32_rna(f);
  return tf32_rna(__fsub_rn(f, __uint_as_float(v)));
}

// One k step of a warp's 2 x 4 tiles into d: A fragments a[mi], B fragments
// b[nj]. For f32 operands the products small·big, big·small and big·big,
// in that order, small terms first (small·small, about 2^-22 of a product,
// is dropped); the fragments are split in place and a and b hold the big
// halves afterwards.
template <typename T>
__device__ __forceinline__ void mma_step(typename Mma<T>::Acc (*d)[4][4],
                                         uint32_t (&a)[2][4],
                                         uint32_t (&b)[4][2]) {
  if constexpr (std::is_same<T, float>::value) {
    uint32_t bs[4][2];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int j = 0; j < 2; ++j) bs[nj][j] = split_tf32(b[nj][j]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      uint32_t as[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) as[r] = split_tf32(a[mi][r]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        Mma<float>::run(d[mi][nj], as, b[nj][0], b[nj][1]);
        Mma<float>::run(d[mi][nj], a[mi], bs[nj][0], bs[nj][1]);
        Mma<float>::run(d[mi][nj], a[mi], b[nj][0], b[nj][1]);
      }
    }
  } else {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        Mma<T>::run(d[mi][nj], a[mi], b[nj][0], b[nj][1]);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
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

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Staged rows are KB = 32 bytes, unpadded; the 16-byte half h of row r
// sits at byte r * 32 + 16 * (h ^ bit 2 of r), so the 8 rows an ldmatrix
// reads at once (any 8 consecutive rows) fall in 8 distinct bank groups.
__device__ __forceinline__ int swz(int row, int half) {
  return row * KB + ((half ^ ((row >> 2) & 1)) << 4);
}

// The block's input patch, chunk by chunk: vector k of this thread is
// 16-byte half (i & 1) of patch row i >> 1, i = tid + k * MMA_THREADS, at
// sample-local pixel pix[k] (n·H·W + h·W + w; bit k of `inside` clear: a
// zero-padding position). A vector holds VE elements of the staged type TS;
// `load` reads one chunk's VE raw elements of x's type TX into registers
// (16 bytes, or 8 for bf16 x staged as f32); `store` masks them, each
// element once, and writes them to shared memory in TS. `vec`: C is a
// multiple of 16 bytes of TX and x 16-byte aligned, so a vector is one load.
template <typename TX, typename TS>
struct Patch {
  static constexpr int VE = 16 / static_cast<int>(sizeof(TS));
  using Raw = typename std::conditional<VE * sizeof(TX) == 16, uint4,
                                        uint2>::type;
  uint32_t pix[MAXV];
  unsigned inside;
  int n;                      // vectors of the whole patch (2 per row)
  Raw raw[MAXV];

  __device__ __forceinline__ void init(const Geom& g, int n0, int ih0,
                                       int iw0, int tid) {
    n = 2 * g.NB * g.PH * g.PW;
    inside = 0;
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int row = (tid + k * MMA_THREADS) >> 1;
      const int pw = row % g.PW, ph = (row / g.PW) % g.PH,
                nb = row / (g.PW * g.PH);
      const int nn = n0 + nb, ih = ih0 + ph, iw = iw0 + pw;
      pix[k] = (static_cast<uint32_t>(nn) * g.H + ih) * g.W + iw;
      if (tid + k * MMA_THREADS < n && nn < g.N && ih >= 0 && ih < g.H &&
          iw >= 0 && iw < g.W)
        inside |= 1u << k;
    }
  }

  __device__ __forceinline__ void load(const TX* __restrict__ x,
                                       const Geom& g, int c0, bool vec,
                                       int tid) {
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int c = c0 + ((tid + k * MMA_THREADS) & 1) * VE;
      raw[k] = Raw{};
      if (!((inside >> k) & 1) || c >= g.C) continue;
      const TX* src = x + static_cast<size_t>(pix[k]) * g.C + c;
      if (vec) {
        raw[k] = __ldg(reinterpret_cast<const Raw*>(src));
      } else {
        alignas(16) TX e[VE];
#pragma unroll
        for (int j = 0; j < VE; ++j)
          e[j] = c + j < g.C ? src[j] : Ld<TX>::narrow(0);
        raw[k] = *reinterpret_cast<const Raw*>(e);
      }
    }
  }

  template <typename Mask>
  __device__ __forceinline__ void store(unsigned char* patch,
                                        const Mask& mask, const Geom& g,
                                        int c0, int tid) const {
    static_assert(MMA_THREADS % 2 == 0, "one half of a row a thread");
    const int c = c0 + (tid & 1) * VE;   // every vector's channels
    const auto m = mask.template channels<VE>(c, g.C);
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int i = tid + k * MMA_THREADS;
      if (i >= n) break;
      alignas(16) TX e[VE];
      *reinterpret_cast<Raw*>(e) = raw[k];
      unsigned char* dst = patch + swz(i >> 1, i & 1);
      if constexpr (std::is_same<TX, TS>::value) {   // masked in place
        if ((inside >> k) & 1) {
#pragma unroll
          for (int j = 0; j < VE; ++j) {
            if (c + j < g.C)
              e[j] = Ld<TS>::narrow(
                  m.apply(pix[k], j, Ld<TX>::widen(e[j])));
          }
        }
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(e);
      } else {
        alignas(16) TS o[VE];
#pragma unroll
        for (int j = 0; j < VE; ++j)
          o[j] = ((inside >> k) & 1) && c + j < g.C
                     ? Ld<TS>::narrow(m.apply(pix[k], j, Ld<TX>::widen(e[j])))
                     : Ld<TS>::narrow(0);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
      }
    }
  }
};

// Issue the cp.async copies of one chunk's weights for taps t0 .. t0 + nt
// into `ws` ([nt * MMA_BN rows][KB bytes], tap-major) from wk (KH·KW, F,
// Cp): thread tid copies 16-byte half tid % 2 of output channel f0 + tid / 2
// for every tap (zeros past F). Bit 2 of a row, which the swizzle reads, is
// the channel's, so tap t's copy lands t * MMA_BN * KB bytes further on.
template <typename T>
__device__ __forceinline__ void stage_weights(unsigned char* ws,
                                              const T* __restrict__ wk,
                                              const Geom& g, int Cp, int f0,
                                              int c0, int t0, int nt,
                                              int tid) {
  static_assert(MMA_THREADS == 2 * MMA_BN, "one half row a thread and tap");
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
  const int f = f0 + (tid >> 1);
  const bool ok = f < g.F;
  const size_t step = static_cast<size_t>(g.F) * Cp;   // elements a tap
  const T* src = wk + t0 * step + static_cast<size_t>(ok ? f : 0) * Cp + c0 +
                 (tid & 1) * VE;
  unsigned char* dst = ws + swz(tid >> 1, tid & 1);
  for (int t = 0; t < nt; ++t)
    cp_async16(dst + t * MMA_BN * KB, src + t * step, ok);
}

// x of type TX, staged (masked) and multiplied as TS, the type of wk
template <typename TX, typename TS, typename Mask>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    conv_mma_kernel(const TX* __restrict__ x, const TS* __restrict__ wk,
                    Mask mask, void* __restrict__ out, Geom g, Epi e,
                    int Cp, int vec) {
  using Acc = typename Mma<TS>::Acc;
  constexpr int CE = KB / static_cast<int>(sizeof(TS));  // channels a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int taps = g.KH * g.KW;
  const int tg = taps < TAP_GROUP ? taps : TAP_GROUP;
  const int wbytes = tg * MMA_BN * KB;
  unsigned char* wbuf = smem_raw;                       // 2 x wbytes
  unsigned char* patch = smem_raw + 2 * wbytes;         // NB*PH*PW*KB

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.z;
  x += s * g.xstride;
  const int tw_i = blockIdx.x % g.tiles_w;
  const int th_i = (blockIdx.x / g.tiles_w) % g.tiles_h;
  const int tn_i = blockIdx.x / (g.tiles_w * g.tiles_h);
  const int n0 = tn_i * g.NB, oh0 = th_i * g.TH, ow0 = tw_i * g.TW;
  const int ih0 = oh0 * g.st - g.pt, iw0 = ow0 * g.st - g.pl;
  const int f0 = blockIdx.y * MMA_BN;
  const int tpix = g.TH * g.TW;
  const int bm = g.NB * tpix;
  const int wm = warp >> 2, wn = warp & 3;   // the warp's 32 x 32 part
  mask.begin(s);

  // ldmatrix rows of this lane: A, pixel wm*32 + mi*16 + lane%16 at its
  // patch position (a pixel past the tile reads position 0 and is not
  // stored), half lane/16; B, output channel wn*32 + (lane/16)*8 + lane%8
  // (+16), half (lane/8)%2
  int arow[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int p = wm * 32 + mi * 16 + (lane & 15);
    const int nb = p / tpix, ohl = (p / g.TW) % g.TH, owl = p % g.TW;
    arow[mi] = p < bm ? (nb * g.PH + ohl * g.st) * g.PW + owl * g.st : 0;
  }
  const int ah = lane >> 4;
  // B rows of tap t: t * MMA_BN + brow (+16); bit 2 is brow's, so the
  // swizzled offset is t * MMA_BN * KB + boff (+16 rows)
  const int boff =
      swz(wn * 32 + (lane >> 4) * 8 + (lane & 7), (lane >> 3) & 1);

  Patch<TX, TS> pt;
  pt.init(g, n0, ih0, iw0, tid);
  pt.load(x, g, 0, vec != 0, tid);

  // float sums a chunk in `part`, then adds it to `acc`; int8's int32 sums
  // are exact in any order and go straight to `acc`. On the f32 route the
  // total lives in shared memory instead (`tot`, after the patch; each
  // thread its own 32 words, word q at q * MMA_THREADS + tid,
  // conflict-free): the split fragments of three TF32 products leave no
  // room for it in the 128 registers that two blocks an SM allow.
  constexpr bool two_level = std::is_same<Acc, float>::value;
  constexpr bool tot_smem = std::is_same<TS, float>::value;
  float* tot = reinterpret_cast<float*>(patch + g.NB * g.PH * g.PW * KB);
  Acc acc[2][4][4], part[2][4][4];
  Acc(*sum)[4][4] = two_level ? part : acc;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[mi][nj][r] = part[mi][nj][r] = Acc(0);
        if constexpr (tot_smem)
          tot[((mi * 4 + nj) * 4 + r) * MMA_THREADS + tid] = 0.f;
      }
  auto total = [&](int mi, int nj, int r) -> Acc& {
    if constexpr (tot_smem)
      return tot[((mi * 4 + nj) * 4 + r) * MMA_THREADS + tid];
    else
      return acc[mi][nj][r];
  };

  // the pipeline's units: chunk ci, taps t0 .. t0 + nt (every tap when
  // KH·KW <= TAP_GROUP); the K order is (chunk, tap, channel) whatever
  // the grouping, and the tensor core sums one chunk's taps from zero
  const int groups = (taps + tg - 1) / tg;
  const int units = (g.C + CE - 1) / CE * groups;
  stage_weights(wbuf, wk, g, Cp, f0, 0, 0, tg, tid);
  cp_async_commit();
  for (int u = 0; u < units; ++u) {
    const int ci = u / groups, t0 = (u % groups) * tg;
    const int nt = taps - t0 < tg ? taps - t0 : tg;
    const unsigned char* wcur = wbuf + (u & 1) * wbytes;
    if (u + 1 < units) {
      const int c1 = (u + 1) / groups, t1 = ((u + 1) % groups) * tg;
      stage_weights(wbuf + ((u + 1) & 1) * wbytes, wk, g, Cp, f0, c1 * CE,
                    t1, taps - t1 < tg ? taps - t1 : tg, tid);
    }
    cp_async_commit();
    if (t0 == 0) {
      // this chunk's patch from the registers, then the next chunk's
      // loads, in flight during this chunk's products
      pt.store(patch, mask, g, ci * CE, tid);
      if (ci * CE + CE < g.C) pt.load(x, g, (ci + 1) * CE, vec != 0, tid);
    }
    cp_async_wait_one();
    __syncthreads();
    int kh = t0 / g.KW, kw = t0 % g.KW;
    for (int t = 0; t < nt; ++t) {
      const int toff = kh * g.PW + kw;
      if (++kw == g.KW) {
        kw = 0;
        ++kh;
      }
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], patch + swz(arow[mi] + toff, ah));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, wcur + t * MMA_BN * KB + boff + nj * 16 * KB);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
      mma_step<TS>(sum, a, b);
    }
    if (two_level && t0 + nt == taps) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            total(mi, nj, r) = Mma<TS>::add(total(mi, nj, r),
                                            part[mi][nj][r]);
            part[mi][nj][r] = Acc(0);
          }
    }
    __syncthreads();
  }

  // epilogue on the fragments: element r of tile (mi, nj) is pixel row
  // lane/4 (+8 for r >= 2), channel 2·(lane%4) (+1 for odd r); the affine
  // rows of the thread's 8 channels are read once
  float sc[4][2], bi[4][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int f = f0 + wn * 32 + nj * 8 + (lane & 3) * 2 + j;
      sc[nj][j] = 1.f;
      bi[nj][j] = 0.f;
      if (f < g.F) affine_of<Acc>(e, g.F, f, &sc[nj][j], &bi[nj][j]);
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = wm * 32 + mi * 16 + (lane >> 2) + half * 8;
      if (p >= bm) continue;
      const int n = n0 + p / tpix, oh = oh0 + (p / g.TW) % g.TH,
                ow = ow0 + p % g.TW;
      if (n >= g.N || oh >= g.Ho || ow >= g.Wo) continue;
      const size_t obase =
          (((static_cast<size_t>(s) * g.N + n) * g.Ho + oh) * g.Wo + ow) *
          g.F;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // channels f, f + 1 (f even): one store when both exist and F is
        // even (then obase + f is even too)
        const int f = f0 + wn * 32 + nj * 8 + (lane & 3) * 2;
        const float y0 = epi_y(e, total(mi, nj, half * 2), sc[nj][0],
                               bi[nj][0]);
        const float y1 = epi_y(e, total(mi, nj, half * 2 + 1), sc[nj][1],
                               bi[nj][1]);
        if (f + 1 < g.F && g.F % 2 == 0) {
          store_y2(e, y0, y1, obase + f, out);
        } else {
          if (f < g.F) store_y(e, y0, obase + f, out);
          if (f + 1 < g.F) store_y(e, y1, obase + f + 1, out);
        }
      }
    }
  }
}

// ------------------------------------------------- the 1x1 routine (wgmma)

// (The file's header describes the routine.) A, the masked input of an
// item, is K-major: 128-byte rows of 64 channels, one 8 KiB chunk of 64
// rows a k chunk, 128-byte swizzled; a ring stage is the same for 128
// output channels of the weights. The ring runs on across the F tiles and
// the items, so a tile's epilogue overlaps the next tile's loads.
constexpr int PW_CONSUMERS = 256;            // two warpgroups
constexpr int PW_STAGERS = 256;              // two warpgroups
constexpr int PW_PRODUCER = PW_CONSUMERS + PW_STAGERS;   // its first thread
constexpr int PW_THREADS = PW_PRODUCER + 32;  // and the producer warp
constexpr int PW_CLUSTER = 4;                // blocks sharing a weight load
constexpr int PW_BM = 64;                    // output pixels of an item
constexpr int PW_BN = 128;                   // output channels of an F tile
constexpr int PW_KC = 64;                    // channels of a k chunk
constexpr int PW_CHUNK = PW_BM * PW_KC * 2;  // bytes of A a chunk: 8 KiB
constexpr int PW_STAGE = PW_BN * PW_KC * 2;  // bytes of a ring stage: 16 KiB
constexpr int PW_SLICE = PW_BN / PW_CLUSTER;  // rows a block loads a stage
constexpr int PW_MAX_KP = 1024;              // A at most 128 KiB
constexpr int PW_MAX_SMEM = 227 * 1024;      // a block's, at most
constexpr int PW_MAX_STAGES = 8;             // ring stages, at most
constexpr int PW_MAX_NBUF = 3;               // A buffers, at most
constexpr uint32_t NO_PIXEL = 0xFFFFFFFFu;

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the stagers' own barrier (named barrier 1)
__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PW_STAGERS) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive on the barrier and expect `bytes` of TMA writes in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// if `pred`, arrive on the barrier at the same offset in block `cta` of the
// cluster (predicated inside, so no branch sits between wgmma operations)
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t cta,
                                               bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 ra;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(bar),
      "r"(cta), "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// wait for the phase of the given parity to complete (the loop inside, so
// no branch sits between wgmma operations)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// rows r0 .. r0 + PW_SLICE - 1, channels c0 .. c0 + 63 of the (F, Cp)
// weights to shared address `dst` of every block of the cluster, each
// block's barrier `bar` counting the bytes (zeros past F and Cp)
__device__ __forceinline__ void tma_multicast(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar),
      "h"(static_cast<uint16_t>((1u << PW_CLUSTER) - 1))
      : "memory");
}

// a box of x's tensor map at coordinates c (innermost first) to shared
// address `dst`, the barrier `bar` counting its bytes (zeros outside x)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rank,
                                         const int (&c)[3]) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (rank == 2) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(m), "r"(c[0]), "r"(c[1]), "r"(bar)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
        "l"(m), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(bar)
        : "memory");
  }
}

// the 16-byte unit j of row r of a 128-byte-swizzled tile whose base is
// 1024-byte aligned: bits 4-6 of the offset xor bits 7-9 (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B)
__device__ __forceinline__ int sw128(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

// the wgmma descriptor of a K-major tile at shared address `addr`: 128-byte
// rows, 128-byte swizzle, 8-row groups 1024 bytes apart; a k step of 16
// channels further on is addr + 32
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of d across the asynchronous
// wgmma that writes it
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16) · B (64 x 16)^T, bf16 -> f32; scale_d 0: d = A · B^T.
// Element (row, col) of d: row = 16·(warp % 4) + lane/4 (+8 for the odd
// pairs), col = 8·(i / 4) + 2·(lane % 4) + i % 2, for d[i].
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The 32 epilogue values y of a consumer thread's part of an F tile, at out:
// y[4·nb + 2·half + k] is row rlo + 8·half (rows from element `base` on, F
// apart; none at or past nrows), column fw + 8·nb + k. Where the thread's
// columns are all in F and F is even, pairs in one store each; at the
// tile's edge element by element.
__device__ __forceinline__ void store_tile_1x1(const Epi& e,
                                               const float (&y)[32],
                                               void* out, size_t base,
                                               long long nrows, int rlo,
                                               int fw, int F) {
  if (F % 2 == 0 && fw + 57 < F) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rlo + 8 * half;
      if (r >= nrows) continue;
      const size_t o = base + static_cast<size_t>(r) * F + fw;
      if (e.out_kind == OUT_BF16) {
        auto* d = static_cast<__nv_bfloat16*>(out) + o;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          *reinterpret_cast<__nv_bfloat162*>(d + 8 * nb) =
              __floats2bfloat162_rn(y[4 * nb + 2 * half],
                                    y[4 * nb + 2 * half + 1]);
      } else if (e.out_kind == OUT_F32) {
        auto* d = static_cast<float*>(out) + o;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          *reinterpret_cast<float2*>(d + 8 * nb) =
              make_float2(y[4 * nb + 2 * half], y[4 * nb + 2 * half + 1]);
      } else {
        auto* d = static_cast<int8_t*>(out) + o;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          *reinterpret_cast<char2*>(d + 8 * nb) =
              make_char2(int8_of(e, y[4 * nb + 2 * half]),
                         int8_of(e, y[4 * nb + 2 * half + 1]));
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = rlo + 8 * ((i >> 1) & 1), f = fw + 8 * (i >> 2) + (i & 1);
    if (r < nrows && f < F)
      store_y(e, y[i], base + static_cast<size_t>(r) * F + f, out);
  }
}

// The epilogue of a consumer thread's 32 f32 totals (rows and columns as
// store_tile_1x1 takes them): affine_of and epi_y in place, then the store
__device__ __forceinline__ void store_epilogue(const Epi& e, float (&y)[32],
                                               void* out, size_t base,
                                               long long nrows, int rlo,
                                               int fw, int F) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int f = fw + nb * 8;
    float sc[2] = {1.f, 1.f}, bi[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (f + k < F) affine_of<float>(e, F, f + k, &sc[k], &bi[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      y[nb * 4 + i] = epi_y(e, y[nb * 4 + i], sc[i & 1], bi[i & 1]);
  }
  store_tile_1x1(e, y, out, base, nrows, rlo, fw, F);
}

// Eight bf16 values of x (one 16-byte vector of a row whose hash key is
// rkey, channels with the keys key1, key2) under the MC mask: a kept value
// times the scale, rounded to bf16, a dropped one 0; two to a word
template <typename Mask>
__device__ __forceinline__ uint4 mask_bf16x8(uint4 w4, uint32_t rkey,
                                             const uint32_t (&key1)[8],
                                             const uint32_t (&key2)[8],
                                             const Mask& mask) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&w4);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool lo =
        bayestpu::keyed_bits(rkey, key1[2 * k], key2[2 * k]) < mask.thresh;
    const bool hi = bayestpu::keyed_bits(rkey, key1[2 * k + 1],
                                         key2[2 * k + 1]) < mask.thresh;
    const __nv_bfloat162 sc2 = __floats2bfloat162_rn(
        __fmul_rn(__uint_as_float(w[k] << 16), mask.scale),
        __fmul_rn(__uint_as_float(w[k] & 0xFFFF0000u), mask.scale));
    w[k] = *reinterpret_cast<const uint32_t*>(&sc2) &
           ((lo ? 0x0000FFFFu : 0u) | (hi ? 0xFFFF0000u : 0u));
  }
  return w4;
}

// A stager's vectors of A: 16-byte unit cv of row r, for r = sid / kv +
// (PW_STAGERS / kv)·i and cv = sid % kv carried along (kv vectors a row);
// with kv dividing PW_STAGERS, cv stays the thread's own.
struct VecWalk {
  int r, cv, kv;
  __device__ __forceinline__ VecWalk(int sid, int kv_)
      : r(sid / kv_), cv(sid % kv_), kv(kv_) {}
  __device__ __forceinline__ bool more() const { return r < PW_BM; }
  __device__ __forceinline__ void next() {
    r += PW_STAGERS / kv;
    cv += PW_STAGERS % kv;
    if (cv >= kv) {
      cv -= kv;
      ++r;
    }
  }
};

// A persistent block's work: items t = blockIdx.x + j·gridDim.x, j < J, an
// item one sample s = t % S of pixel tile t / S (64 output pixels; at
// stride 2, R output rows), so the S items of one tile run side by side
// and a shared x is read from memory about once. An item past the
// tiles·S real ones has no rows: its block masks and stores nothing but
// keeps its part in the cluster's weight loads.
//
// The block's warps split the work: two consumer warpgroups run the
// products and the epilogue; two stager warpgroups stage each item's A
// into one of `nbuf` buffers (one thread fetches it by TMA an item ahead;
// each thread then masks its vectors of it in place); one producer warp
// keeps the weights' ring full.
template <typename Mask>
__global__ void __cluster_dims__(PW_CLUSTER, 1, 1)
    __launch_bounds__(PW_THREADS, 1)
    conv_mma_kernel_1x1(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, Mask mask,
                        void* __restrict__ out, Geom g, Epi e, int R,
                        int stages, int nbuf, int J) {
  using B = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled tiles start at a 1024-byte boundary
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int nkc = (g.C + PW_KC - 1) / PW_KC;   // k chunks
  const int abytes = nkc * PW_CHUNK;
  unsigned char* A = sm;                       // nbuf x abytes
  unsigned char* ring = A + nbuf * abytes;     // stages x PW_STAGE
  // each buffer's rows: input pixel (NO_PIXEL: none) and hash key
  uint2* rows = reinterpret_cast<uint2*>(ring + stages * PW_STAGE);
  // barriers: a ring stage's full (its TMA bytes are in) and empty (the
  // cluster's consumers are done with it); an A buffer's full (staged) and
  // empty (the consumers are done with it)
  const uint32_t full0 = smem_addr(rows + PW_MAX_NBUF * PW_BM);
  const uint32_t empty0 = full0 + 8 * stages;
  const uint32_t afull0 = empty0 + 8 * stages;
  const uint32_t aempty0 = afull0 + 8 * PW_MAX_NBUF;
  const uint32_t araw0 = aempty0 + 8 * PW_MAX_NBUF;   // its TMA bytes in

  const int tid = threadIdx.x;
  const long long M = static_cast<long long>(g.N) * g.Ho * g.Wo;
  // items a sample: 64 output pixels each at stride 1; at stride 2, R
  // output rows (R·Wo pixels) of the N·Ho a sample, across images
  const long long orows = static_cast<long long>(g.N) * g.Ho;
  const long long items =
      (R > 0 ? (orows + R - 1) / R : (M + PW_BM - 1) / PW_BM) * g.S;
  const int nft = (g.F + PW_BN - 1) / PW_BN;

  if (tid == PW_PRODUCER) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 2 * PW_CLUSTER);   // 2 warpgroups a block
    }
    for (int i = 0; i < nbuf; ++i) {
      mbar_init(afull0 + 8 * i, PW_STAGERS);
      mbar_init(aempty0 + 8 * i, 2);
      mbar_init(araw0 + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // the barriers of every block

  // item j's sample, first output pixel m0 and pixels (none past the
  // end), and the coordinates of its A box in x's tensor map (channel 0)
  auto item = [&](int j, int* s, long long* m0, int* nrows, int (&c)[3]) {
    const long long t = blockIdx.x + static_cast<long long>(j) * gridDim.x;
    *s = static_cast<int>(t % g.S);
    const long long k = t / g.S;
    c[0] = c[1] = c[2] = 0;
    if (t >= items) {
      *m0 = M;
      *nrows = 0;
    } else if (R == 0) {
      *m0 = k * PW_BM;
      *nrows = static_cast<int>(M - *m0 < PW_BM ? M - *m0 : PW_BM);
      c[1] = static_cast<int>((g.xstride ? *s * M : 0) + *m0);
    } else {
      // output row q of the sample reads input row 2q of its N·H (H even)
      const long long q0 = k * R;
      *m0 = q0 * g.Wo;
      *nrows = static_cast<int>(orows - q0 < R ? orows - q0 : R) * g.Wo;
      c[2] = static_cast<int>(
          (g.xstride ? static_cast<long long>(*s) * g.N * g.H : 0) + 2 * q0);
    }
  };

  if (tid >= PW_PRODUCER) {
    // the producer: one lane keeps the ring full, `stages` chunks ahead of
    // the cluster's slowest consumer, the same units for every item
    if (tid == PW_PRODUCER) {
      const int r0 = static_cast<int>(cluster_rank()) * PW_SLICE;
      const uint32_t ring0 = smem_addr(ring);
      int st = 0, ph = 0;
      bool used = false;   // the ring has gone round once
      for (int j = 0; j < J; ++j) {
        for (int ft = 0; ft < nft; ++ft) {
          for (int kc = 0; kc < nkc; ++kc) {
            if (used) mbar_wait(empty0 + 8 * st, ph ^ 1);
            mbar_expect_tx(full0 + 8 * st, PW_STAGE);
            tma_multicast(ring0 + st * PW_STAGE + r0 * 128, &wmap,
                          full0 + 8 * st, kc * PW_KC, ft * PW_BN + r0);
            if (++st == stages) {
              st = 0;
              ph ^= 1;
              used = true;
            }
          }
        }
      }
    }
  } else if (tid >= PW_CONSUMERS) {
    // the stagers: item j into A buffer j % nbuf, once the consumers are
    // done with the item before in it; item j + 1's TMA is in flight while
    // item j is masked
    const int sid = tid - PW_CONSUMERS;
    const int kv = nkc * (PW_KC / 8);          // 16-byte vectors of a row
    // item j's A, raw, into buffer j % nbuf by TMA, once the consumers are
    // done with the buffer (one thread)
    const int abox = (R > 0 ? R * g.Wo : PW_BM) * 128;   // bytes a chunk
    auto fetch = [&](int j) {
      const int b = j % nbuf;
      if (j >= nbuf) mbar_wait(aempty0 + 8 * b, (j / nbuf - 1) & 1);
      int s, nrows;
      long long m0;
      int xc[3];
      item(j, &s, &m0, &nrows, xc);
      mbar_expect_tx(araw0 + 8 * b, abox * nkc);
      for (int kc = 0; kc < nkc; ++kc) {
        xc[0] = kc * PW_KC;
        tma_load(smem_addr(A + b * abytes + kc * PW_CHUNK), &xmap,
                 araw0 + 8 * b, R > 0 ? 3 : 2, xc);
      }
    };
    if (sid == 0) fetch(0);
    uint32_t key1[8], key2[8];
    int keyed_cv = -1;
    for (int j = 0; j < J; ++j) {
      const int b = j % nbuf;
      // the item's row table: input pixel and hash key of each output
      int s, nrows;
      long long m0;
      int xc[3];
      item(j, &s, &m0, &nrows, xc);
      uint2* rt = rows + b * PW_BM;
      stagers_sync();   // every stager is done with the slot's last rows
      if (sid < PW_BM) {
        uint2 row = make_uint2(NO_PIXEL, 0u);
        if (sid < nrows) {   // then m < 2^32: N·H·W is
          const uint32_t m = static_cast<uint32_t>(m0 + sid);
          const uint32_t hw = static_cast<uint32_t>(g.Ho) * g.Wo;
          const uint32_t n = m / hw, q = m % hw;
          const uint32_t Wo = static_cast<uint32_t>(g.Wo);
          row.x = (n * g.H + (q / Wo) * g.st) * g.W + (q % Wo) * g.st;
          mask.begin(s);
          row.y = mask.row_key(row.x);
        }
        rt[sid] = row;
      }
      stagers_sync();
      mbar_wait(araw0 + 8 * b, (j / nbuf) & 1);
      // masked in place, each element once: kept values times the scale,
      // rounded to bf16, two to a word
      unsigned char* Ab = A + b * abytes;
#pragma unroll 1
      for (VecWalk v(sid, kv); v.more(); v.next()) {
        const int r = v.r, cv = v.cv;
        const uint2 row = rt[r];
        const int c = cv * 8;
        if (row.x == NO_PIXEL || c >= g.C) continue;   // zeros stay
        if (cv != keyed_cv) {
          keyed_cv = cv;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            key1[k] = bayestpu::col_key1(static_cast<uint32_t>(c + k));
            key2[k] = bayestpu::col_key2(static_cast<uint32_t>(c + k));
          }
        }
        uint4* p = reinterpret_cast<uint4*>(Ab + (cv >> 3) * PW_CHUNK +
                                            sw128(r, cv & 7));
        *p = mask_bf16x8(*p, row.y, key1, key2, mask);
      }
      fence_proxy_async();   // generic-proxy writes, for wgmma to read
      mbar_arrive(afull0 + 8 * b);
      if (sid == 0 && j + 1 < J) fetch(j + 1);
    }
  } else {
    // the consumers: the F tiles over A; per k chunk, the tensor core sums
    // 64 channels from zero (part), then that partial is added to the f32
    // total (tot), so a sum over K rounds like an f32 sum
    const int lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
    const uint32_t b0 = smem_addr(ring) + wg * (PW_BN / 2) * 128;
    const int rlo = (warp & 3) * 16 + (lane >> 2);   // rows rlo, rlo + 8
    float part[32], tot[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = tot[i] = 0.f;
    int st = 0, ph = 0;                  // the ring's stage and phase
    for (int j = 0; j < J; ++j) {
      const int b = j % nbuf;
      mbar_wait(afull0 + 8 * b, (j / nbuf) & 1);
      int s, nrows;
      long long m0;
      int xc[3];
      item(j, &s, &m0, &nrows, xc);
      const uint32_t a0 = smem_addr(A + b * abytes);
      for (int ft = 0; ft < nft; ++ft) {
        for (int kc = 0; kc < nkc; ++kc) {
          mbar_wait(full0 + 8 * st, ph);
          const uint32_t as = a0 + kc * PW_CHUNK;
          const uint32_t bs = b0 + st * PW_STAGE;
          fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < PW_KC / 16; ++kk)
            wgmma_m64n64k16(part, sw128_desc(as + kk * 32),
                            sw128_desc(bs + kk * 32), kk);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(part);
          // the warpgroup is done with the stage: tell every producer
          mbar_arrive_at(empty0 + 8 * st,
                         static_cast<uint32_t>(tid & (PW_CLUSTER - 1)),
                         (tid & 127) < PW_CLUSTER);
          if (++st == stages) {
            st = 0;
            ph ^= 1;
          }
#pragma unroll
          for (int i = 0; i < 32; ++i)
            tot[i] = kc == 0 ? part[i] : __fadd_rn(tot[i], part[i]);
        }
        // the warpgroup is done with A after the item's last products
        if (ft + 1 == nft && (tid & 127) == 0) mbar_arrive(aempty0 + 8 * b);
        // the epilogue of F tile ft, as conv_mma_kernel's
        store_epilogue(e, tot, out, (static_cast<size_t>(s) * M + m0) * g.F,
                       nrows, rlo,
                       ft * PW_BN + wg * (PW_BN / 2) + (lane & 3) * 2, g.F);
      }
    }
  }
  __syncwarp();
  cluster_sync();   // no block leaves while a peer may still signal it
}

// ------------------------------------------ the window routine (wgmma)

// (The file's header describes the routine.) An item is R output rows of
// one sample (R·Wo pixels, up to WN_MAX_TILES 64-row M tiles), across
// images where Wo is small. Its band in shared memory holds, for each k
// chunk of 64 channels, the item's slots one after another: slot k of an
// image's run of r output rows from oh on is input row 2·oh - pad_top + k
// (2r + 1 slots a run, zeros outside the image). A slot is two halves of P
// 128-byte rows (P = Wo + 1 rounded up to 8), the even columns c' = 0, 2,
// .., 2·Wo of the shifted column c' = iw + pad_left, then the odd ones,
// each half 1024-byte aligned and 128-byte swizzled as TMA writes it. Tap
// (kh, kw) of output pixel (i, ow) of the item (i its output row, g the
// run it lies in) reads row ow + kw / 2 of half kw % 2 of slot 2i + g + kh.
constexpr int WN_CONSUMERS = 256;                    // two warpgroups
constexpr int WN_STAGERS = 192;                      // six warps
constexpr int WN_FETCH = WN_CONSUMERS + WN_STAGERS;  // the band's TMA warp
constexpr int WN_PRODUCER = WN_FETCH + 32;           // the weights' warp
constexpr int WN_THREADS = WN_PRODUCER + 32;  // 16 warps: 128 registers
constexpr int WN_TAPS = 9;         // a 3 x 3 window
constexpr int WN_MAX_TILES = 4;    // 64-pixel M tiles of an item, at most
constexpr int WN_MAX_SLOTS = 96;   // slots of a band, at most
constexpr int WN_MAX_KC = 16;      // k chunks: C at most 1,024
constexpr int WN_MAX_NBUF = 2;     // bands, at most
constexpr int WN_MIN_STAGES = 4;   // ring stages, at least
constexpr int WN_MAX_WO = 127;     // output columns: a TMA box of 2·(Wo + 1)
// shared memory beside the bands and the ring: the alignment, the slot
// table and the barriers
constexpr int WN_FIXED =
    1024 + WN_MAX_SLOTS * 4 +
    (2 * PW_MAX_STAGES + 3 * WN_MAX_NBUF * WN_MAX_KC) * 8;
static_assert(WN_THREADS == 512, "four warps an SM sub-partition");

// the window routine's stagers' own barrier (named barrier 2)
__device__ __forceinline__ void window_stagers_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(WN_STAGERS) : "memory");
}

// a shape's plan (window_plan): R output rows an item, nbuf bands, the
// ring's stages, a band's slots and P
struct WindowPlan {
  int R, nbuf, stages, slots, P;
};

__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4],
                                               uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (+)= A (64 x 16, in registers: each warp's 16 rows as the m16n8k16 A
// fragment) · B (64 x 16)^T, bf16 -> f32; d as wgmma_m64n64k16's
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d = A · B^T, as wgmma_m64n64k16_rs with scale_d 0: d's values are not
// read (outputs only), so d holds nothing live before it
__device__ __forceinline__ void wgmma_m64n64k16_rs_zero(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// a box of x's window map (window_x_map) at coordinates (channel, column,
// row, image) to shared address `dst`, the barrier `bar` counting its
// bytes (zeros outside x)
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

namespace window {

// Item j of this block: sample s, first output row q0 of the sample's N·Ho
// and its output rows nout (0: an item past the end, which keeps its part
// in the cluster's weight loads and masks and stores nothing). The S
// items of one band of rows run side by side, so a shared x is read from
// memory about once.
struct Item {
  int s;
  int q0;   // N·Ho < 2^31: x has fewer pixels
  int nout;
};

__device__ __forceinline__ Item item_of(const Geom& g, int R, int j) {
  const long long t = blockIdx.x + static_cast<long long>(j) * gridDim.x;
  const int rows = g.N * g.Ho;
  const long long q0 = t / g.S * R;
  Item it;
  it.s = static_cast<int>(t % g.S);
  it.q0 = q0 < rows ? static_cast<int>(q0) : rows;
  it.nout = rows - it.q0 < R ? rows - it.q0 : R;
  return it;
}

// slots of an item: 2·nout, and one more for each image it spans
__device__ __forceinline__ int item_slots(const Geom& g, const Item& it) {
  if (it.nout == 0) return 0;
  return 2 * it.nout + (it.q0 + it.nout - 1) / g.Ho - it.q0 / g.Ho + 1;
}

// slot k of an item: its image n and input row ih (outside 0 .. H - 1: a
// row of zeros)
__device__ __forceinline__ void slot_at(const Geom& g, const Item& it,
                                        int k, int* n, int* ih) {
  int q = it.q0;
  for (int left = it.nout; left > 0;) {
    const int oh = q % g.Ho;
    const int r = g.Ho - oh < left ? g.Ho - oh : left;
    if (k <= 2 * r) {
      *n = q / g.Ho;
      *ih = 2 * oh - g.pt + k;
      return;
    }
    k -= 2 * r + 1;
    q += r;
    left -= r;
  }
}

// The window routine: persistent blocks, one an SM, clusters of 4, whose
// warps split the work. Two consumer warpgroups run the products and the
// epilogue of each (F tile, M tile) of an item, 64 output channels each;
// two stager warpgroups mask each k chunk of an item's band in place, each
// element once, as its TMA bytes come in; a fetch warp loads the bands'
// chunks by TMA as they free up; a producer warp keeps the weights' ring
// full. A band's chunk is free once the item's last (F tile, M tile) is
// done with it, so with one band the next item's chunks are fetched and
// masked while the last F tile runs.
template <typename Mask>
__global__ void __cluster_dims__(PW_CLUSTER, 1, 1)
    __launch_bounds__(WN_THREADS, 1)
    conv_mma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, Mask mask,
                    void* __restrict__ out, Geom g, Epi e, WindowPlan p,
                    int J) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled tiles start at a 1024-byte boundary
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int nkc = g.C / PW_KC;                  // k chunks
  const int SB = 2 * p.P * 128;                 // bytes of a slot's chunk
  const int CB = p.slots * SB;                  // bytes of a band's chunk
  const int BB = nkc * CB;                      // bytes of a band
  unsigned char* band = sm;                     // nbuf x BB
  unsigned char* ring = band + p.nbuf * BB;     // stages x PW_STAGE
  // the slot table of the item being masked: the hash row of the slot's
  // column 0, (n·H + ih)·W, or NO_PIXEL for a row of zeros
  uint32_t* table = reinterpret_cast<uint32_t*>(ring + p.stages * PW_STAGE);
  // barriers: a ring stage's full (its TMA bytes are in) and empty (the
  // cluster's consumers are done with it); a band chunk's full (masked),
  // empty (the consumers are done with it) and raw (its TMA bytes are in),
  // chunk kc of band b at index b·WN_MAX_KC + kc
  const uint32_t full0 = smem_addr(table + WN_MAX_SLOTS);
  const uint32_t empty0 = full0 + 8 * PW_MAX_STAGES;
  const uint32_t afull0 = empty0 + 8 * PW_MAX_STAGES;
  const uint32_t aempty0 = afull0 + 8 * WN_MAX_NBUF * WN_MAX_KC;
  const uint32_t araw0 = aempty0 + 8 * WN_MAX_NBUF * WN_MAX_KC;

  const int tid = threadIdx.x;
  const int nft = (g.F + PW_BN - 1) / PW_BN;
  const int mtiles = (p.R * g.Wo + PW_BM - 1) / PW_BM;

  if (tid == WN_PRODUCER) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 2 * PW_CLUSTER);   // 2 warpgroups a block
    }
    for (int b = 0; b < p.nbuf; ++b)
      for (int kc = 0; kc < nkc; ++kc) {
        const uint32_t o = 8 * (b * WN_MAX_KC + kc);
        mbar_init(afull0 + o, WN_STAGERS);
        mbar_init(aempty0 + o, 2);
        mbar_init(araw0 + o, 1);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // the barriers of every block

  if (tid >= WN_PRODUCER) {
    // the producer: one lane keeps the ring full, `stages` units ahead of
    // the cluster's slowest consumer; per item the units (F tile, M tile, k
    // chunk, tap), tap t of F tile ft at row t·F + ft·128 of the (KH·KW·F,
    // Cp) weights (rows past the tap's F, never stored, read the next tap's)
    if (tid == WN_PRODUCER) {
      const int r0 = static_cast<int>(cluster_rank()) * PW_SLICE;
      const uint32_t ring0 = smem_addr(ring);
      int st = 0, ph = 0;
      bool used = false;   // the ring has gone round once
      for (int j = 0; j < J; ++j)
        for (int ft = 0; ft < nft; ++ft)
          for (int mt = 0; mt < mtiles; ++mt)
            for (int kc = 0; kc < nkc; ++kc)
              for (int t = 0; t < WN_TAPS; ++t) {
                if (used) mbar_wait(empty0 + 8 * st, ph ^ 1);
                mbar_expect_tx(full0 + 8 * st, PW_STAGE);
                tma_multicast(ring0 + st * PW_STAGE + r0 * 128, &wmap,
                              full0 + 8 * st, kc * PW_KC,
                              t * g.F + ft * PW_BN + r0);
                if (++st == p.stages) {
                  st = 0;
                  ph ^= 1;
                  used = true;
                }
              }
    }
  } else if (tid >= WN_FETCH) {
    // the fetch warp: one lane loads chunk kc of item j's band, raw, into
    // band j % nbuf once the consumers are done with that chunk of the
    // item before in it: per slot its even and its odd columns, Wo + 1
    // each at a stride of 2 (zeros outside x)
    if (tid == WN_FETCH) {
      const uint32_t box = static_cast<uint32_t>(g.Wo + 1) * 128;
      for (int j = 0; j < J; ++j) {
        const int b = j % p.nbuf;
        const Item it = item_of(g, p.R, j);
        const int nsl = item_slots(g, it);
        const int n0 = g.xstride ? it.s * g.N : 0;
        for (int kc = 0; kc < nkc; ++kc) {
          const uint32_t o = 8 * (b * WN_MAX_KC + kc);
          if (j >= p.nbuf) mbar_wait(aempty0 + o, (j / p.nbuf - 1) & 1);
          mbar_expect_tx(araw0 + o, 2 * box * nsl);
          const uint32_t dst = smem_addr(band + b * BB + kc * CB);
          for (int k = 0; k < nsl; ++k) {
            int n = 0, ih = 0;
            slot_at(g, it, k, &n, &ih);
            for (int h = 0; h < 2; ++h)
              tma_load4(dst + k * SB + h * p.P * 128, &xmap, araw0 + o,
                        kc * PW_KC, h - g.pl, ih, n0 + n);
          }
        }
      }
    }
  } else if (tid >= WN_CONSUMERS) {
    // the stagers: each k chunk of item j's band masked in place as its
    // bytes come in, each element once; a thread keeps its 16-byte unit cv
    // (8 channels) and walks the chunk's 128-byte rows
    const int sid = tid - WN_CONSUMERS;
    const int cv = sid & 7;
    constexpr int STEP = WN_STAGERS / 8;   // rows a step
    const int P2 = 2 * p.P;
    uint32_t key1[8], key2[8];
    for (int j = 0; j < J; ++j) {
      const int b = j % p.nbuf;
      const Item it = item_of(g, p.R, j);
      const int nsl = item_slots(g, it);
      mask.begin(it.s);
      window_stagers_sync();   // every stager is done with the last table
      if (sid < nsl) {
        int n = 0, ih = 0;
        slot_at(g, it, sid, &n, &ih);
        table[sid] = ih >= 0 && ih < g.H
                         ? (static_cast<uint32_t>(n) * g.H + ih) * g.W
                         : NO_PIXEL;
      }
      window_stagers_sync();
      for (int kc = 0; kc < nkc; ++kc) {
        const uint32_t o = 8 * (b * WN_MAX_KC + kc);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t c = static_cast<uint32_t>(kc * PW_KC + cv * 8 + k);
          key1[k] = bayestpu::col_key1(c);
          key2[k] = bayestpu::col_key2(c);
        }
        mbar_wait(araw0 + o, (j / p.nbuf) & 1);
        unsigned char* chunk = band + b * BB + kc * CB;
        // row rho of the chunk: slot rho / 2P, half (rho % 2P) / P,
        // position rho % P, column c' = 2·position + half
        int rho = sid >> 3;
        int slot = rho / P2, rem = rho - slot * P2;
#pragma unroll 1
        for (; rho < nsl * P2; rho += STEP) {
          const int hf = rem >= p.P;
          const int cs = 2 * (rem - hf * p.P) + hf;   // c'
          const int iw = cs - g.pl;
          const uint32_t base = table[slot];
          if (cs <= 2 * g.Wo && iw >= 0 && iw < g.W && base != NO_PIXEL) {
            uint4* v = reinterpret_cast<uint4*>(chunk + rho * 128 +
                                                ((cv ^ (rho & 7)) << 4));
            *v = mask_bf16x8(*v, mask.row_key(base + iw), key1, key2, mask);
          }
          rem += STEP;
          while (rem >= P2) {
            rem -= P2;
            ++slot;
          }
        }
        fence_proxy_async();   // generic-proxy writes, for the consumers
        mbar_arrive(afull0 + o);
      }
    }
  } else {
    // the consumers: per (F tile, M tile) of an item and per k chunk, the
    // tensor core sums the chunk's 9 taps of 64 channels from zero (part),
    // then that partial is added to the f32 total (tot), so a sum over K
    // rounds like an f32 sum. A comes from the band by ldmatrix into
    // registers, two k steps a wgmma group, one group in flight a
    // warpgroup: the two warpgroups take turns on the tensor core.
    const int lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
    const int hf = lane >> 4;                       // the lane's k half
    const int rlo = (warp & 3) * 16 + (lane >> 2);  // rows rlo, rlo + 8
    const uint32_t band0 = smem_addr(band);
    const uint32_t b0 = smem_addr(ring) + wg * (PW_BN / 2) * 128;
    const int M = g.N * g.Ho * g.Wo;   // under 2^31: x has more pixels
    float part[32], tot[32];
    uint32_t a[2][4];   // a group's two k steps of A
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[i] = 0.f;
    int st = 0, ph = 0;   // the ring's stage and phase
    for (int j = 0; j < J; ++j) {
      const int b = j % p.nbuf;
      const Item it = item_of(g, p.R, j);
      const uint32_t bandb = band0 + b * BB;
      const int oh0 = it.q0 % g.Ho;   // the item's first output row's
      for (int ft = 0; ft < nft; ++ft) {
        for (int mt = 0; mt < mtiles; ++mt) {
          // the lane's A row: pixel m of the item (past its pixels pixel
          // 0, not stored), at output row i, column ow, in the item's run
          // `run`
          const int m = mt * PW_BM + (warp & 3) * 16 + (lane & 15);
          int i = 0, ow = 0;
          if (m < it.nout * g.Wo) {
            i = m / g.Wo;
            ow = m - i * g.Wo;
          }
          const int run = (oh0 + i) / g.Ho;
          const uint32_t lrow = bandb + (2 * i + run) * SB + ow * 128;
          const bool last = ft + 1 == nft && mt + 1 == mtiles;
          for (int kc = 0; kc < nkc; ++kc) {
            const uint32_t o = 8 * (b * WN_MAX_KC + kc);
            if (ft == 0 && mt == 0) mbar_wait(afull0 + o, (j / p.nbuf) & 1);
            // tap (kh, kw): the chunk's first tap starts its sum from zero,
            // so part is written before it is read there (a wgmma that
            // reads none) and is dead between the chunks
            auto tap = [&](auto first_tap, int kh, int kw) {
              constexpr bool first = decltype(first_tap)::value;
              mbar_wait(full0 + 8 * st, ph);
              const uint32_t ta = lrow + kc * CB + kh * SB +
                                  (kw & 1) * p.P * 128 + (kw >> 1) * 128;
              const int p7 = (ow + (kw >> 1)) & 7;
              const uint32_t bs = b0 + st * PW_STAGE;
#pragma unroll
              for (int q = 0; q < 2; ++q) {
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                  const int kk = 2 * q + k;
                  ldmatrix_x4_at(a[k], ta + ((((kk << 1) | hf) ^ p7) << 4));
                }
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                  const int kk = 2 * q + k;
                  if (first && kk == 0)
                    wgmma_m64n64k16_rs_zero(part, a[k], sw128_desc(bs));
                  else
                    wgmma_m64n64k16_rs(part, a[k], sw128_desc(bs + kk * 32),
                                       1);
                }
                wgmma_commit();
                wgmma_wait_all();
                fence_regs(part);
              }
              // the tap's products are done with its stage: tell every
              // producer
              mbar_arrive_at(empty0 + 8 * st,
                             static_cast<uint32_t>(tid & (PW_CLUSTER - 1)),
                             (tid & 127) < PW_CLUSTER);
              if (++st == p.stages) {
                st = 0;
                ph ^= 1;
              }
            };
            tap(std::true_type{}, 0, 0);
#pragma unroll 1
            for (int t = 1; t < WN_TAPS; ++t)
              tap(std::false_type{}, t / 3, t % 3);
            // the item's last products are done with the band's chunk
            if (last && (tid & 127) == 0) mbar_arrive(aempty0 + o);
#pragma unroll
            for (int r = 0; r < 32; ++r)
              tot[r] = kc == 0 ? part[r] : __fadd_rn(tot[r], part[r]);
          }
          // the epilogue of (F tile ft, M tile mt), as conv_mma_kernel's
          store_epilogue(
              e, tot, out,
              (static_cast<size_t>(it.s) * M + it.q0 * g.Wo + mt * PW_BM) *
                  g.F,
              it.nout * g.Wo - mt * PW_BM, rlo,
              ft * PW_BN + wg * (PW_BN / 2) + (lane & 3) * 2, g.F);
        }
      }
    }
  }
  __syncwarp();
  cluster_sync();   // no block leaves while a peer may still signal it
}

}  // namespace window

// ---------------------------------------------------------------- launch

// dims: N, H, W, C, F, KH, KW, stride, pad_top, pad_left, Ho, Wo, S, and
// row0 (the MC mask's row offset; the bank and mask-free routines ignore
// it).
int read_dims(const int* dims, int x_carries, Geom* g) {
  Geom& q = *g;
  q.N = dims[0]; q.H = dims[1]; q.W = dims[2]; q.C = dims[3]; q.F = dims[4];
  q.KH = dims[5]; q.KW = dims[6]; q.st = dims[7]; q.pt = dims[8];
  q.pl = dims[9]; q.Ho = dims[10]; q.Wo = dims[11]; q.S = dims[12];
  if (q.N <= 0 || q.Ho <= 0 || q.Wo <= 0 || q.F <= 0 || q.S <= 0) return 1;
  if (q.C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  q.xstride = x_carries
                  ? static_cast<long long>(q.N) * q.H * q.W * q.C
                  : 0;
  return 0;
}

void set_patch(Geom* g) {
  g->PH = (g->TH - 1) * g->st + g->KH;
  g->PW = (g->TW - 1) * g->st + g->KW;
}

int patch_rows(const Geom& g) { return g.NB * g.PH * g.PW; }

// The output tile of a block, fixed by the shape alone (never by S or the
// launch kind): up to 8 x 8 outputs of NB images, 64 pixels in all, NB
// halved until the patch fits in MAX_PATCH_ROWS. Where it does not fit at
// NB = 1 (a window and stride over 8 x 8 outputs beyond 19 x 19 inputs, as
// 7 x 7 at stride 2), the tile's longer side is halved until it does, down
// to one output: fewer pixels a block (the rest of its rows read patch
// position 0 and are not stored). A window of more than MAX_PATCH_ROWS taps
// fits no tile and is refused (the wrapper refuses it first, by name).
// Shared memory: two stages of weights (up to TAP_GROUP taps of one chunk,
// 36 KiB each), the patch (12 KiB at most) and `extra` bytes (the f32
// route's total).
int make_mma_geom(const int* dims, int x_carries, size_t extra, Geom* g,
                  size_t* smem) {
  const int rc = read_dims(dims, x_carries, g);
  if (rc != 0) return rc;
  Geom& q = *g;
  q.TW = q.Wo < 8 ? q.Wo : 8;
  q.TH = q.Ho < 8 ? q.Ho : 8;
  q.NB = MMA_BM / (q.TH * q.TW);
  if (q.NB > q.N) q.NB = q.N;
  set_patch(g);
  while (patch_rows(q) > MAX_PATCH_ROWS && q.NB > 1) q.NB = (q.NB + 1) / 2;
  while (patch_rows(q) > MAX_PATCH_ROWS && (q.TH > 1 || q.TW > 1)) {
    if (q.TH >= q.TW)
      q.TH = (q.TH + 1) / 2;
    else
      q.TW = (q.TW + 1) / 2;
    set_patch(g);
  }
  if (patch_rows(q) > MAX_PATCH_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int taps = q.KH * q.KW;
  *smem = 2 * static_cast<size_t>(taps < TAP_GROUP ? taps : TAP_GROUP) *
              MMA_BN * KB +
          static_cast<size_t>(patch_rows(q)) * KB + extra;
  q.tiles_h = (q.Ho + q.TH - 1) / q.TH;
  q.tiles_w = (q.Wo + q.TW - 1) / q.TW;
  return 0;
}

template <typename K>
int allow_smem(K kern, bool* set, int limit = MAX_SMEM) {
  if (*set) return 0;                  // once per instantiation
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  *set = true;
  return 0;
}

// The 1x1 routine's shapes: a 1x1 window with no padding (every output
// reads an input pixel), C a multiple of 8 (x's TMA rows) and of at most
// PW_MAX_KP channels (its A tile), x 16-byte aligned and under 2^31 pixels
// (TMA coordinates are int32), and at stride 2 H even (x's TMA map) and at
// most PW_BM output columns (an item's row).
bool takes_1x1(const Geom& g, const void* x) {
  return g.KH == 1 && g.KW == 1 && g.pt == 0 && g.pl == 0 &&
         (g.Ho - 1) * g.st < g.H && (g.Wo - 1) * g.st < g.W &&
         (g.C + PW_KC - 1) / PW_KC * PW_KC <= PW_MAX_KP && g.C % 8 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         (g.st == 1 || (g.Wo <= PW_BM && g.H % 2 == 0)) &&
         static_cast<long long>(g.N) * g.H * g.W * (g.xstride ? g.S : 1) <
             (1LL << 31);
}

// The TMA map of the weights wk (1, F, Cp) bf16: boxes of 64 channels by
// PW_SLICE rows, 128-byte swizzled, zeros past F and Cp. The encoder,
// cuTensorMapEncodeTiled, is found through the CUDA runtime (no link to
// libcuda); a host call, so a captured launch replays the map it was given.
int tensor_map_encoder(PFN_cuTensorMapEncodeTiled_v12000* out) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fn == nullptr || q != cudaDriverEntryPointSuccess)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  *out = encode;
  return 0;
}

int weight_map(const void* wk, int F, int Cp, CUtensorMap* map) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  const int err = tensor_map_encoder(&encode);
  if (err != 0) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Cp),
                              static_cast<cuuint64_t>(F)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Cp) * 2};
  const cuuint32_t box[2] = {PW_KC, PW_SLICE};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wk), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The TMA map of x (N, H, W, C) bf16, or (S, N, H, W, C) where it carries
// the samples: at stride 1 the (pixels, C) matrix, boxes of 64 channels by
// 64 pixels; at stride 2 (channel, column, row of the N·H or S·N·H), boxes
// of 64 channels by Wo columns by R rows, every other column and row (H is
// even, so the rows a sample reads are the even ones, across its images).
// 128-byte swizzled, zeros past C and x's edges.
int x_map(const void* x, const Geom& g, int R, CUtensorMap* map) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  const int err = tensor_map_encoder(&encode);
  if (err != 0) return err;
  const cuuint64_t imgs = static_cast<cuuint64_t>(g.N) * (g.xstride ? g.S : 1);
  const cuuint64_t row = static_cast<cuuint64_t>(g.C) * 2;   // bytes
  CUresult r;
  if (R == 0) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(g.C),
                                imgs * g.H * g.W};
    const cuuint64_t strides[1] = {row};
    const cuuint32_t box[2] = {PW_KC, PW_BM};
    const cuuint32_t elem[2] = {1, 1};
    r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(g.C),
                                static_cast<cuuint64_t>(g.W), imgs * g.H};
    const cuuint64_t strides[2] = {row, row * g.W};
    const cuuint32_t box[3] = {PW_KC, static_cast<cuuint32_t>(g.Wo * g.st),
                               static_cast<cuuint32_t>(R * g.st)};
    const cuuint32_t elem[3] = {1, static_cast<cuuint32_t>(g.st),
                                static_cast<cuuint32_t>(g.st)};
    r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// conv_mma_kernel_1x1 on bf16 x and wk (1, F, Cp), Cp = C rounded up to 16:
// one persistent block an SM, as many clusters as fit at once. Shared
// memory: the A buffers (C rounded up to 64, 128 bytes a row of 64
// channels; two where four ring stages still fit beside them, so up to C =
// 512), the ring (as many stages as fit, up to PW_MAX_STAGES), the row
// tables and the ring's barriers, plus 1 KiB to align A.
template <typename Mask>
int launch_1x1(const void* x, const void* wk, const Mask& mask, void* out,
               const Geom& g, const Epi& e, void* stream) {
  const int Cp = (g.C + 15) / 16 * 16;
  // output rows an item at stride 2 (R·Wo pixels, at most 64); 0: the
  // items are 64 pixels of the flat (pixels, C) view
  const int R = g.st == 1 ? 0 : PW_BM / g.Wo;
  const size_t a_bytes =
      static_cast<size_t>((g.C + PW_KC - 1) / PW_KC) * PW_CHUNK;
  const size_t fixed = 1024 + PW_MAX_NBUF * PW_BM * sizeof(uint2) +
                       3 * PW_MAX_NBUF * sizeof(uint64_t);
  const size_t per_stage = PW_STAGE + 2 * sizeof(uint64_t);
  int nbuf = PW_MAX_NBUF;   // the most A buffers beside 4 stages, else 1
  while (nbuf > 1 && fixed + nbuf * a_bytes + 4 * per_stage > PW_MAX_SMEM)
    --nbuf;
  int stages =
      static_cast<int>((PW_MAX_SMEM - fixed - nbuf * a_bytes) / per_stage);
  if (stages > PW_MAX_STAGES) stages = PW_MAX_STAGES;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fixed + nbuf * a_bytes + stages * per_stage;
  CUtensorMap map, xm;
  int err = weight_map(wk, g.F, Cp, &map);
  if (err == 0) err = x_map(x, g, R, &xm);
  if (err != 0) return err;
  auto* kern = conv_mma_kernel_1x1<Mask>;
  // the attribute once; the clusters that fit at once for each smem size
  static bool smem_set = false;
  static size_t occ_smem = 0;
  static int occ_clusters = 0;
  err = allow_smem(kern, &smem_set, PW_MAX_SMEM);
  if (err != 0) return err;
  if (occ_smem != smem) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(PW_CLUSTER);
    cfg.blockDim = dim3(PW_THREADS);
    cfg.dynamicSmemBytes = smem;
    int n = 0;
    const cudaError_t r = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(kern), &cfg);
    if (r != cudaSuccess) return static_cast<int>(r);
    if (n < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    occ_smem = smem;
    occ_clusters = n;
  }
  const long long M = static_cast<long long>(g.N) * g.Ho * g.Wo;
  const long long items =
      (R > 0 ? (static_cast<long long>(g.N) * g.Ho + R - 1) / R
             : (M + PW_BM - 1) / PW_BM) *
      g.S;
  long long clusters = (items + PW_CLUSTER - 1) / PW_CLUSTER;
  if (clusters > occ_clusters) clusters = occ_clusters;
  const long long blocks = clusters * PW_CLUSTER;
  const long long J = (items + blocks - 1) / blocks;
  if (J > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), PW_THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      xm, map, mask, out, g, e, R, stages, nbuf, static_cast<int>(J));
  return static_cast<int>(cudaGetLastError());
}

// The most slots an item of R output rows takes: 2R, and one for each
// image it spans (the items start at q0 = kR of the N·Ho rows; q0 mod Ho
// repeats within k < Ho, and a short last item takes no more than a whole
// one at its residue)
int window_slots(const Geom& g, int R) {
  const long long rows = static_cast<long long>(g.N) * g.Ho;
  int most = 0;
  for (long long k = 0; k < g.Ho && k * R < rows; ++k) {
    const long long q0 = k * R, q1 = (q0 + R < rows ? q0 + R : rows) - 1;
    const int slots =
        static_cast<int>(2 * (q1 - q0 + 1) + q1 / g.Ho - q0 / g.Ho + 1);
    if (slots > most) most = slots;
  }
  return most;
}

// The window routine's plan, fixed by the shape alone (never by S or the
// launch kind): of the items of R output rows (R·Wo at most WN_MAX_TILES ·
// 64 pixels) whose bands fit in shared memory beside WN_MIN_STAGES ring
// stages, the one whose 64-row M tiles are filled most, counting any fill
// of 7/8 or more as full; then the one with two bands over one; then the
// fuller; then the larger R (the least halo). The ring takes what is left,
// up to PW_MAX_STAGES. False: no R fits.
bool window_plan(const Geom& g, WindowPlan* plan, size_t* smem) {
  const int P = (g.Wo + 1 + 7) / 8 * 8;
  const long long SB = 2LL * P * 128, nkc = g.C / PW_KC;
  const long long rows = static_cast<long long>(g.N) * g.Ho;
  long long best = -1;
  for (int R = 1; R <= rows && R * g.Wo <= WN_MAX_TILES * PW_BM; ++R) {
    const int slots = window_slots(g, R);
    if (slots > WN_MAX_SLOTS) continue;
    const long long band = nkc * slots * SB;
    int nbuf = WN_MAX_NBUF;
    while (nbuf > 0 && WN_FIXED + nbuf * band +
                               WN_MIN_STAGES * PW_STAGE > PW_MAX_SMEM)
      --nbuf;
    if (nbuf == 0) continue;
    const int tiles = (R * g.Wo + PW_BM - 1) / PW_BM;
    const int fill = 1000 * R * g.Wo / (PW_BM * tiles);   // per mille
    const long long key =
        (((fill < 875 ? fill : 875) * 4LL + nbuf) * 1001 + fill) * 1024 + R;
    if (key <= best) continue;
    best = key;
    long long stages = (PW_MAX_SMEM - WN_FIXED - nbuf * band) / PW_STAGE;
    if (stages > PW_MAX_STAGES) stages = PW_MAX_STAGES;
    *plan = WindowPlan{R, nbuf, static_cast<int>(stages), slots, P};
    *smem = WN_FIXED + nbuf * band + stages * PW_STAGE;
  }
  return best >= 0;
}

// The window routine's shapes: a 3x3 window at stride 2 with a top and a
// left pad of 0 or 1, C a multiple of 64 and at most WN_MAX_KC chunks,
// x 16-byte aligned and under 2^31 pixels (TMA coordinates are int32), at
// most WN_MAX_WO output columns (x's TMA box), and a plan that fits.
bool takes_window(const Geom& g, const void* x) {
  WindowPlan p;
  size_t smem = 0;
  return g.KH == 3 && g.KW == 3 && g.st == 2 && (g.pt == 0 || g.pt == 1) &&
         (g.pl == 0 || g.pl == 1) && g.C % PW_KC == 0 &&
         g.C <= WN_MAX_KC * PW_KC && g.Wo <= WN_MAX_WO &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         static_cast<long long>(g.N) * g.H * g.W * (g.xstride ? g.S : 1) <
             (1LL << 31) &&
         window_plan(g, &p, &smem);
}

// The window routine's TMA map of x (N, H, W, C) bf16, or (S, N, H, W, C)
// where it carries the samples: (channel, column, row, image), boxes of 64
// channels by Wo + 1 columns at a stride of 2 by one row, 128-byte
// swizzled, zeros outside x (a row or column of the padding).
int window_x_map(const void* x, const Geom& g, CUtensorMap* map) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  const int err = tensor_map_encoder(&encode);
  if (err != 0) return err;
  const cuuint64_t row = static_cast<cuuint64_t>(g.C) * 2;   // bytes
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(g.C), static_cast<cuuint64_t>(g.W),
      static_cast<cuuint64_t>(g.H),
      static_cast<cuuint64_t>(g.N) * (g.xstride ? g.S : 1)};
  const cuuint64_t strides[3] = {row, row * g.W, row * g.W * g.H};
  const cuuint32_t box[4] = {PW_KC, static_cast<cuuint32_t>(2 * (g.Wo + 1)),
                             1, 1};
  const cuuint32_t elem[4] = {1, 2, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// window::conv_mma_kernel on bf16 x and wk (9, F, Cp), Cp = C: one
// persistent block an SM, as many clusters as fit at once, the plan of
// window_plan.
template <typename Mask>
int launch_window(const void* x, const void* wk, const Mask& mask, void* out,
                  const Geom& g, const Epi& e, void* stream) {
  WindowPlan p;
  size_t smem = 0;
  if (!window_plan(g, &p, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map, xm;
  int err = weight_map(wk, g.KH * g.KW * g.F, (g.C + 15) / 16 * 16, &map);
  if (err == 0) err = window_x_map(x, g, &xm);
  if (err != 0) return err;
  auto* kern = window::conv_mma_kernel<Mask>;
  static bool smem_set = false;
  static size_t occ_smem = 0;
  static int occ_clusters = 0;
  err = allow_smem(kern, &smem_set, PW_MAX_SMEM);
  if (err != 0) return err;
  if (occ_smem != smem) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(PW_CLUSTER);
    cfg.blockDim = dim3(WN_THREADS);
    cfg.dynamicSmemBytes = smem;
    int n = 0;
    const cudaError_t r = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(kern), &cfg);
    if (r != cudaSuccess) return static_cast<int>(r);
    if (n < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    occ_smem = smem;
    occ_clusters = n;
  }
  const long long rows = static_cast<long long>(g.N) * g.Ho;
  const long long items = (rows + p.R - 1) / p.R * g.S;
  long long clusters = (items + PW_CLUSTER - 1) / PW_CLUSTER;
  if (clusters > occ_clusters) clusters = occ_clusters;
  const long long blocks = clusters * PW_CLUSTER;
  const long long J = (items + blocks - 1) / blocks;
  if (J > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), WN_THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(xm, map, mask, out, g, e, p,
                                              static_cast<int>(J));
  return static_cast<int>(cudaGetLastError());
}

// x of type TX, wk (KH·KW, F, Cp) of the staged type TS with Cp = C
// rounded up to 32 bytes of TS, zero-padded. An MC conv of bf16 x and w at
// a shape that takes_1x1 takes runs the 1x1 routine, at one that
// takes_window takes the window routine, every other conv the implicit
// GEMM; the shape and the types decide, never S or the launch kind.
template <typename TX, typename TS, typename Mask>
int launch_mma(const void* x, const void* wk, const Mask& mask, void* out,
               const int* dims, int x_carries, const Epi& e, void* stream) {
  Geom g;
  if constexpr (std::is_same<TS, __nv_bfloat16>::value &&
                std::is_same<Mask, HashMask<__nv_bfloat16>>::value) {
    const int rc = read_dims(dims, x_carries, &g);
    if (rc == 1) return 0;             // nothing to compute
    if (rc != 0) return rc;
    if (takes_1x1(g, x)) return launch_1x1(x, wk, mask, out, g, e, stream);
    if (takes_window(g, x))
      return launch_window(x, wk, mask, out, g, e, stream);
  }
  size_t smem = 0;
  const int rc = make_mma_geom(
      dims, x_carries, std::is_same<TS, float>::value ? TOTAL_BYTES : 0, &g,
      &smem);
  if (rc == 1) return 0;               // nothing to compute
  if (rc != 0) return rc;
  constexpr int CE = KB / static_cast<int>(sizeof(TS));
  const int Cp = (g.C + CE - 1) / CE * CE;
  const int vec = (g.C * static_cast<int>(sizeof(TX))) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto* kern = conv_mma_kernel<TX, TS, Mask>;
  static bool smem_set = false;
  const int err = allow_smem(kern, &smem_set);
  if (err != 0) return err;
  const long long tiles_n = (g.N + g.NB - 1) / g.NB;
  const dim3 grid(static_cast<unsigned>(tiles_n * g.tiles_h * g.tiles_w),
                  (g.F + MMA_BN - 1) / MMA_BN, g.S);
  kern<<<grid, MMA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TX*>(x), static_cast<const TS*>(wk), mask, out, g,
      e, Cp, vec);
  return static_cast<int>(cudaGetLastError());
}

// The float MC kernels: bf16 x with bf16 w staged and multiplied in bf16;
// any f32 operand makes the f32 route (the wrapper widens a bf16 w to f32
// exactly; a bf16 x is masked in bf16, then widened), three TF32 products a
// k step, as the float bank kernels.
template <template <typename> class MaskT, typename Make>
int launch_float(const void* x, const void* w, void* out, const int* dims,
                 int x_carries, const Epi& e, int x_bf16, int w_bf16,
                 void* stream, Make make) {
  using B = __nv_bfloat16;
  if (x_bf16 && w_bf16)
    return launch_mma<B, B>(x, w, make(MaskT<B>{}), out, dims, x_carries, e,
                            stream);
  if (x_bf16)
    return launch_mma<B, float>(x, w, make(MaskT<B>{}), out, dims,
                                x_carries, e, stream);
  return launch_mma<float, float>(x, w, make(MaskT<float>{}), out, dims,
                                  x_carries, e, stream);
}

int masked_conv(const void* x, const void* w, const void* seeds,
                uint32_t thresh, const Epi& e, void* out, const int* dims,
                int x_carries, float scale, int x_bf16, int w_bf16,
                void* stream) {
  if (seeds == nullptr) {
    return launch_float<NoMask>(x, w, out, dims, x_carries, e, x_bf16,
                                w_bf16, stream, [](auto m) { return m; });
  }
  const auto* sd = static_cast<const int32_t*>(seeds);
  return launch_float<HashMask>(
      x, w, out, dims, x_carries, e, x_bf16, w_bf16, stream, [&](auto m) {
        m.seeds = sd;
        m.thresh = thresh;
        m.scale = scale;
        m.row0 = static_cast<uint32_t>(dims[13]);
        return m;
      });
}

int masked_conv_int8(const void* x, const void* w, const void* seeds,
                     uint32_t thresh, const Epi& e, void* out,
                     const int* dims, int x_carries, void* stream) {
  if (seeds == nullptr) {
    return launch_mma<int8_t, int8_t>(x, w, NoMask<int8_t>{}, out, dims,
                                      x_carries, e, stream);
  }
  HashMask<int8_t> m{};
  m.seeds = static_cast<const int32_t*>(seeds);
  m.thresh = thresh;
  m.row0 = static_cast<uint32_t>(dims[13]);
  return launch_mma<int8_t, int8_t>(x, w, m, out, dims, x_carries, e,
                                    stream);
}

template <typename TX>
BankMask<TX> bank_mask(const void* bank, const void* idxs, int idx0,
                       int num_masks, const int* dims) {
  BankMask<TX> m{};
  m.bank = static_cast<const float*>(bank);
  m.idxs = static_cast<const int32_t*>(idxs);
  m.idx0 = idx0;
  m.n = num_masks;
  m.C = dims[3];
  return m;
}

// The float bank kernels: x bf16 or f32, w f32, f32 staged and multiplied
// as three TF32 products; the int8 ones on the s8 tensor cores.
int bank_conv(const void* x, const void* w, const void* bank,
              const void* idxs, int idx0, int num_masks, const Epi& e,
              void* out, const int* dims, int x_carries, int x_bf16,
              void* stream) {
  using B = __nv_bfloat16;
  if (x_bf16)
    return launch_mma<B, float>(
        x, w, bank_mask<B>(bank, idxs, idx0, num_masks, dims), out, dims,
        x_carries, e, stream);
  return launch_mma<float, float>(
      x, w, bank_mask<float>(bank, idxs, idx0, num_masks, dims), out, dims,
      x_carries, e, stream);
}

int bank_conv_int8(const void* x, const void* w, const void* bank,
                   const void* idxs, int idx0, int num_masks, const Epi& e,
                   void* out, const int* dims, int x_carries, void* stream) {
  return launch_mma<int8_t, int8_t>(
      x, w, bank_mask<int8_t>(bank, idxs, idx0, num_masks, dims), out, dims,
      x_carries, e, stream);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0
// on success); it neither allocates nor synchronises. Every entry ends in
// the same arguments:
//   affine   the (2, F) f32 [scale; bias] stack of the epilogue, or null;
//   out      (S, N, Ho, Wo, F) of out_kind's type;
//   dims     a host array (N, H, W, C, F, KH, KW, stride, pad_top,
//            pad_left, Ho, Wo, S, row0); one sample is S = 1; row0 is the
//            MC mask's hash row of x's first pixel as a uint32 (b0·H·W
//            for the images from global image b0 on; 0: the whole batch),
//            unused by the bank entries;
//   fscale   the dropout scale (float MC kernels: 1/(1 - rate) in x's
//            type), or out_scale (int8 kernels); unused by the float bank
//            kernels;
//   out_kind 0 f32, 1 bf16, 2 int8, and inv_step the f32 of 1 / out_step;
//   relu     nonzero for a relu after the affine;
//   x_bf16, w_bf16  the float kernels' element types (0: f32); unused by
//            the int8 kernels, w_bf16 also by the float bank ones;
//   stream.
// The MC entries, float and int8, serve one sample and S alike: they take
// `seeds` ((2,) for S = 1, (S, 2); null: no mask, for conv_fused and
// conv_int8_fused) and the keep threshold; x is (N, H, W, C), shared by
// the S samples, or in the _xs entries (S, N, H, W, C), sample s of x
// under seeds[s]. Their w is (KH·KW, F, Cp), Cp = C rounded up to 32
// bytes of the staged type and zero-padded: bf16 for bf16 x with bf16 w
// (Cp a multiple of 16), f32 for any other float pair (a multiple of 8),
// int8 (a multiple of 32). The bank
// entries take w (KH·KW, F, Cp) (f32 for the float ones, whatever x's
// type, Cp a multiple of 8; int8 for the int8 ones, Cp a multiple of 32),
// the f32 (num_masks, C) bank and an int index (single) or S int32
// indices (samples; _xs: x (S, N, H, W, C), sample s of x under idxs[s]).
#define BT_TAIL                                                            \
  const void *affine, void *out, const int *dims, float fscale,           \
      int out_kind, int relu, float inv_step, int x_bf16, int w_bf16,      \
      void *stream
#define BT_EPI(out_scale)                                             \
  Epi {                                                               \
    static_cast<const float*>(affine), out_kind, relu, inv_step,      \
        out_scale                                                     \
  }

extern "C" int bt_masked_conv(const void* x, const void* w, const void* seeds,
                              uint32_t thresh, BT_TAIL) {
  return masked_conv(x, w, seeds, thresh, BT_EPI(1.f), out, dims, 0, fscale,
                     x_bf16, w_bf16, stream);
}

extern "C" int bt_masked_conv_xs(const void* x, const void* w,
                                 const void* seeds, uint32_t thresh,
                                 BT_TAIL) {
  return masked_conv(x, w, seeds, thresh, BT_EPI(1.f), out, dims, 1, fscale,
                     x_bf16, w_bf16, stream);
}

extern "C" int bt_masked_conv_int8(const void* x, const void* w,
                                   const void* seeds, uint32_t thresh,
                                   BT_TAIL) {
  return masked_conv_int8(x, w, seeds, thresh, BT_EPI(fscale), out, dims, 0,
                          stream);
}

extern "C" int bt_masked_conv_int8_xs(const void* x, const void* w,
                                      const void* seeds, uint32_t thresh,
                                      BT_TAIL) {
  return masked_conv_int8(x, w, seeds, thresh, BT_EPI(fscale), out, dims, 1,
                          stream);
}

extern "C" int bt_bank_conv(const void* x, const void* w, const void* bank,
                            int idx, int num_masks, BT_TAIL) {
  return bank_conv(x, w, bank, nullptr, idx, num_masks, BT_EPI(1.f), out,
                   dims, 0, x_bf16, stream);
}

extern "C" int bt_bank_conv_samples(const void* x, const void* w,
                                    const void* bank, const void* idxs,
                                    int num_masks, BT_TAIL) {
  return bank_conv(x, w, bank, idxs, 0, num_masks, BT_EPI(1.f), out, dims,
                   0, x_bf16, stream);
}

extern "C" int bt_bank_conv_xs(const void* x, const void* w,
                               const void* bank, const void* idxs,
                               int num_masks, BT_TAIL) {
  return bank_conv(x, w, bank, idxs, 0, num_masks, BT_EPI(1.f), out, dims,
                   1, x_bf16, stream);
}

extern "C" int bt_bank_conv_int8(const void* x, const void* w,
                                 const void* bank, int idx, int num_masks,
                                 BT_TAIL) {
  return bank_conv_int8(x, w, bank, nullptr, idx, num_masks, BT_EPI(fscale),
                        out, dims, 0, stream);
}

extern "C" int bt_bank_conv_int8_samples(const void* x, const void* w,
                                         const void* bank, const void* idxs,
                                         int num_masks, BT_TAIL) {
  return bank_conv_int8(x, w, bank, idxs, 0, num_masks, BT_EPI(fscale), out,
                        dims, 0, stream);
}

extern "C" int bt_bank_conv_int8_xs(const void* x, const void* w,
                                    const void* bank, const void* idxs,
                                    int num_masks, BT_TAIL) {
  return bank_conv_int8(x, w, bank, idxs, 0, num_masks, BT_EPI(fscale), out,
                        dims, 1, stream);
}
