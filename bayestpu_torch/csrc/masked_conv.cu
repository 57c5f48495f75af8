// Masked convolutions with a fused epilogue for Hopper (sm_90a), plain C
// interface.
//
// Replaces the two Pallas TPU kernels of bayestpu/kernels/masked_conv.py
// with one routine, conv_mma_kernel<TX, TS, Mask> (x of type TX, staged and
// multiplied as TS), an implicit GEMM on the tensor cores:
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
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
int allow_smem(K kern, bool* set) {
  if (*set) return 0;                  // once per instantiation
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  *set = true;
  return 0;
}

// x of type TX, wk (KH·KW, F, Cp) of the staged type TS with Cp = C
// rounded up to 32 bytes of TS, zero-padded.
template <typename TX, typename TS, typename Mask>
int launch_mma(const void* x, const void* wk, const Mask& mask, void* out,
               const int* dims, int x_carries, const Epi& e, void* stream) {
  Geom g;
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
