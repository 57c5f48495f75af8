// Masked convolutions with a fused epilogue for Hopper (sm_90a), plain C
// interface.
//
// Replaces the two Pallas TPU kernels of bayestpu/kernels/masked_conv.py:
//   conv_kernel<TX, TW, HashMask|NoMask>  <- _masked_conv_kernel (:371-417),
//        launched by _launch_masked (:473-510): dropout_conv,
//        dropout_conv_samples, dropout_conv_inference, conv_fused and the
//        int8 twins dropout_conv_int8{,_samples}, conv_int8_fused
//   conv_kernel<TX, TW, BankMask>         <- _bank_conv_kernel (:430-467),
//        launched by _launch_bank (:513-560): bank_conv{,_samples} and
//        bank_conv_int8{,_samples}
// Each computes, for every sample s, out[s] = epilogue(conv(x ⊙ mask_s, w))
// with x NHWC (N, H, W, C), w (KH, KW, C, F), out (S, N, Ho, Wo, F),
// stride 1 or 2 and any zero padding (the caller resolves XLA's SAME,
// VALID or explicit pairs into the top and left pads; the bottom and right
// ones follow from Ho and Wo). The mask of x element (n, h, w, c):
//   - HashMask: the counter hash of prng.cuh on the GLOBAL, UNPADDED
//     coordinate (n·H·W + h·W + w, c) with seeds[s], i.e. the bits
//     dropout_apply gives x viewed as (N·H·W, C); a kept float value is
//     multiplied by the dropout scale and rounded to x's type (bf16: scale
//     1.3359375 at rate 0.25, as JAX's weak-typed constant), an int8 one
//     kept as it is (1/keep folds into out_scale);
//   - BankMask: row idxs[s] mod n (floor) of the f32 (n, C) bank; the float
//     kernels multiply x, widened to f32, by the row's value, clipped at 0
//     when n > 1 (JAX selects the row as a max over a where, which clips a
//     negative entry to 0); the int8 kernels keep x where the value > 0.5;
//   - NoMask: x as it is (conv_fused, conv_int8_fused).
// Products accumulate in f32 (float kernels; bf16 products are exact) or
// int32 (int8 x int8, exact). The epilogue, in f32 and in _epi_apply's
// order, with the roundings that the JAX kernel has on XLA's CPU backend
// (the reference the tests hold the port to; measured there on every
// element): with the (2, F) affine, y = fma(acc, scale[f], bias[f]) for the
// float kernels and y = fma(f32(acc), f32(out_scale * scale[f]), bias[f])
// for the int8 ones (XLA contracts JAX's y * scale + bias into one fused
// multiply-add and folds the constant out_scale, the f32 of x_step·w_step
// [/(1 - rate)], into the scale row); without it, y = acc or f32(acc) *
// out_scale; relu when asked; then store f32, bf16 (round to nearest even)
// or int8 = clip(trunc(s ± 0.5), -128, 127) with s = y * inv_step. Every
// other multiply and add is written __fmul_rn / __fadd_rn, so nvcc
// contracts nothing else and an int8 output equals JAX's bit for bit.
//
// What bounds it on an H100: at the block-site vgg11 shapes (x 128x16x16x64
// -> 128, 128x8x8x128 -> 256, 128x4x4x256 -> 512, 128x2x2x512 -> 512, 3x3)
// one sample is 4.83 GFLOP (2.42 at the last) against 2-5 MB of bf16
// traffic: operations bound, 0.0049 ms at the 989 TFLOP/s of bf16 tensor
// cores, 0.072 ms at the 67 TFLOP/s of f32 for the bank kernels, whose
// products are f32. This kernel is the simple one, right first, on the
// CUDA cores: a block owns a tile of up to 64 output pixels (NB images x TH
// rows x TW columns) by 64 output channels for ONE sample (grid.z is the
// sample, so sample s of a samples launch runs exactly the single kernel's
// routine and summation order, and the two agree bit for bit). It walks C
// in chunks of BC channels; per chunk it stages the input patch its pixels
// read (halo included) into shared memory, masked ONCE as it is staged,
// so every tap and every output channel of the block reads the masked
// value from there and the hash runs once per staged element, not per
// product; and the chunk's weights for all taps. Each of 256 threads then
// accumulates a 4 x 4 register tile (4 pixels x 4 channels) over taps and
// channels. Tensor cores (wgmma, s8 mma), TMA and one x staging for all
// samples are later work.
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "prng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64;            // output pixels of a block, at most
constexpr int BN = 64;            // output channels of a block
constexpr int RM = 4;             // pixels of a thread
constexpr int RN = 4;             // channels of a thread
constexpr int TM = BM / RM;       // 16 thread rows
constexpr int TN = BN / RN;       // 16 thread columns
constexpr int MAX_SMEM = 200 * 1024;

enum OutKind { OUT_F32 = 0, OUT_BF16 = 1, OUT_INT8 = 2 };

// V: the staged type of an element (f32 for the float types, int32 for
// int8); load widens exactly.
template <typename T>
struct Ld;
template <>
struct Ld<float> {
  using V = float;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
};
template <>
struct Ld<__nv_bfloat16> {
  using V = float;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};
template <>
struct Ld<int8_t> {
  using V = int32_t;
  static __device__ __forceinline__ int32_t load(const int8_t* p) {
    return *p;
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
// staged x value given its global row (n·H·W + h·W + w) and channel.
template <typename TX>
struct NoMask {
  using V = typename Ld<TX>::V;
  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ V apply(uint32_t, int, V v) const { return v; }
};

template <typename TX>
struct HashMask {
  using V = typename Ld<TX>::V;
  const int32_t* seeds;  // (S, 2)
  uint32_t thresh;
  float scale;
  uint32_t stream;
  __device__ __forceinline__ void begin(int s) {
    stream = bayestpu::seed_stream(seeds[2 * s], seeds[2 * s + 1]);
  }
  __device__ __forceinline__ V apply(uint32_t row, int c, V v) const {
    const uint32_t bits =
        bayestpu::coord_bits(row, static_cast<uint32_t>(c), stream);
    return bits < thresh ? keep_scaled<TX>(v, scale) : V(0);
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
  __device__ __forceinline__ V apply(uint32_t, int c, V v) const {
    const float b = __ldg(row + c);
    if constexpr (std::is_same<V, float>::value) {
      return __fmul_rn(v, (n > 1 && !(b > 0.f)) ? 0.f : b);
    } else {
      return b > 0.5f ? v : V(0);
    }
  }
};

struct Geom {
  int N, H, W, C, F, KH, KW, st, pt, pl, Ho, Wo, S;
  int TH, TW, NB, BC, PH, PW;  // tile: NB images x TH x TW outputs
  int tiles_h, tiles_w;
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

template <typename V>
__device__ __forceinline__ V madd(V a, V b, V acc) {
  if constexpr (std::is_same<V, float>::value) {
    return __fmaf_rn(a, b, acc);
  } else {
    return acc + a * b;
  }
}

template <typename TX, typename TW, typename Mask>
__global__ void __launch_bounds__(THREADS)
    conv_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                Mask mask, void* __restrict__ out, Geom g, Epi e) {
  using V = typename Ld<TX>::V;
  static_assert(std::is_same<V, typename Ld<TW>::V>::value,
                "x and w must stage as one type");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* patch = reinterpret_cast<V*>(smem_raw);               // NB*PH*PW*BC
  V* ws = patch + g.NB * g.PH * g.PW * g.BC;               // KH*KW*BC*BN

  const int tid = threadIdx.x;
  const int s = blockIdx.z;
  const int tw_i = blockIdx.x % g.tiles_w;
  const int th_i = (blockIdx.x / g.tiles_w) % g.tiles_h;
  const int tn_i = blockIdx.x / (g.tiles_w * g.tiles_h);
  const int n0 = tn_i * g.NB, oh0 = th_i * g.TH, ow0 = tw_i * g.TW;
  const int f0 = blockIdx.y * BN;
  const int tpix = g.TH * g.TW;
  const int bm = g.NB * tpix;
  const int tr = tid / TN, tc = tid % TN;
  mask.begin(s);

  // this thread's pixels: offsets into the patch and validity
  int pbase[RM];
  bool pvalid[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int p = tr + TM * i;
    const int nb = p / tpix, ohl = (p / g.TW) % g.TH, owl = p % g.TW;
    pvalid[i] = p < bm && n0 + nb < g.N && oh0 + ohl < g.Ho &&
                ow0 + owl < g.Wo;
    pbase[i] = pvalid[i]
                   ? ((nb * g.PH + ohl * g.st) * g.PW + owl * g.st) * g.BC
                   : 0;
  }

  V acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = V(0);

  const uint32_t hw = static_cast<uint32_t>(g.H) * static_cast<uint32_t>(g.W);
  const int taps = g.KH * g.KW;
  const int patch_n = g.NB * g.PH * g.PW * g.BC;
  const int w_n = taps * g.BC * BN;
  const int ih0 = oh0 * g.st - g.pt, iw0 = ow0 * g.st - g.pl;
  for (int c0 = 0; c0 < g.C; c0 += g.BC) {
    // the masked input patch, each element hashed once
    for (int i = tid; i < patch_n; i += THREADS) {
      const int c = i % g.BC;
      const int pos = i / g.BC;
      const int pw = pos % g.PW, ph = (pos / g.PW) % g.PH,
                nb = pos / (g.PW * g.PH);
      const int n = n0 + nb, ih = ih0 + ph, iw = iw0 + pw, cg = c0 + c;
      V v = V(0);
      if (n < g.N && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W &&
          cg < g.C) {
        const size_t off =
            ((static_cast<size_t>(n) * g.H + ih) * g.W + iw) * g.C + cg;
        const uint32_t row = static_cast<uint32_t>(n) * hw +
                             static_cast<uint32_t>(ih * g.W + iw);
        v = mask.apply(row, cg, Ld<TX>::load(x + off));
      }
      patch[i] = v;
    }
    // the chunk's weights for every tap: ws[(t * BC + c) * BN + f]
    for (int i = tid; i < w_n; i += THREADS) {
      const int f = i % BN;
      const int c = (i / BN) % g.BC;
      const int t = i / (BN * g.BC);
      const int cg = c0 + c, fg = f0 + f;
      ws[i] = (cg < g.C && fg < g.F)
                  ? Ld<TW>::load(w + (static_cast<size_t>(t) * g.C + cg) *
                                         g.F + fg)
                  : V(0);
    }
    __syncthreads();
    for (int t = 0; t < taps; ++t) {
      const int toff = ((t / g.KW) * g.PW + t % g.KW) * g.BC;
      const V* wt = ws + t * g.BC * BN + tc;
      for (int c = 0; c < g.BC; ++c) {
        V a[RM], b[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = patch[pbase[i] + toff + c];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = wt[c * BN + TN * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = madd(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (!pvalid[i]) continue;
    const int p = tr + TM * i;
    const int n = n0 + p / tpix, oh = oh0 + (p / g.TW) % g.TH,
              ow = ow0 + p % g.TW;
    const size_t obase =
        (((static_cast<size_t>(s) * g.N + n) * g.Ho + oh) * g.Wo + ow) *
        g.F;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int f = f0 + tc + TN * j;
      if (f >= g.F) continue;
      float y;
      if (e.affine != nullptr) {
        float sc = e.affine[f];
        if constexpr (!std::is_same<V, float>::value) {
          sc = __fmul_rn(e.out_scale, sc);   // int8: out_scale folds in
        }
        y = __fmaf_rn(acc_to_f32(acc[i][j], 1.f), sc, e.affine[g.F + f]);
      } else {
        y = acc_to_f32(acc[i][j], e.out_scale);
      }
      if (e.relu) y = y > 0.f ? y : 0.f;
      if (e.out_kind == OUT_F32) {
        static_cast<float*>(out)[obase + f] = y;
      } else if (e.out_kind == OUT_BF16) {
        static_cast<__nv_bfloat16*>(out)[obase + f] = __float2bfloat16_rn(y);
      } else {
        const float sc = __fmul_rn(y, e.inv_step);
        float r = truncf(__fadd_rn(sc, sc >= 0.f ? 0.5f : -0.5f));
        r = fminf(fmaxf(r, -128.f), 127.f);
        static_cast<int8_t*>(out)[obase + f] = static_cast<int8_t>(r);
      }
    }
  }
}

// dims: N, H, W, C, F, KH, KW, stride, pad_top, pad_left, Ho, Wo, S
int make_geom(const int* dims, size_t elem, Geom* g, size_t* smem) {
  Geom& q = *g;
  q.N = dims[0]; q.H = dims[1]; q.W = dims[2]; q.C = dims[3]; q.F = dims[4];
  q.KH = dims[5]; q.KW = dims[6]; q.st = dims[7]; q.pt = dims[8];
  q.pl = dims[9]; q.Ho = dims[10]; q.Wo = dims[11]; q.S = dims[12];
  if (q.N <= 0 || q.Ho <= 0 || q.Wo <= 0 || q.F <= 0 || q.S <= 0) return 1;
  q.TW = q.Wo < 8 ? q.Wo : 8;
  q.TH = q.Ho < 8 ? q.Ho : 8;
  q.NB = BM / (q.TH * q.TW);
  if (q.NB < 1) q.NB = 1;
  if (q.NB > q.N) q.NB = q.N;
  const int taps = q.KH * q.KW;
  q.BC = 16;
  while (q.BC > 1 && static_cast<size_t>(taps) * q.BC * BN * elem > 96 * 1024)
    q.BC /= 2;
  q.PH = (q.TH - 1) * q.st + q.KH;
  q.PW = (q.TW - 1) * q.st + q.KW;
  for (;;) {
    *smem = (static_cast<size_t>(q.NB) * q.PH * q.PW * q.BC +
             static_cast<size_t>(taps) * q.BC * BN) * elem;
    if (*smem <= MAX_SMEM || q.NB == 1) break;
    q.NB = (q.NB + 1) / 2;
  }
  if (*smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (q.C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  q.tiles_h = (q.Ho + q.TH - 1) / q.TH;
  q.tiles_w = (q.Wo + q.TW - 1) / q.TW;
  return 0;
}

template <typename TX, typename TW, typename Mask>
int launch(const void* x, const void* w, const Mask& mask, void* out,
           const int* dims, const Epi& e, void* stream) {
  Geom g;
  size_t smem = 0;
  const int rc = make_geom(dims, sizeof(typename Ld<TX>::V), &g, &smem);
  if (rc == 1) return 0;               // nothing to compute
  if (rc != 0) return rc;
  const long long tiles_n = (g.N + g.NB - 1) / g.NB;
  const long long gx = tiles_n * g.tiles_h * g.tiles_w;
  auto* kern = conv_kernel<TX, TW, Mask>;
  static bool smem_set = false;        // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid(static_cast<unsigned>(gx), (g.F + BN - 1) / BN, g.S);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), mask, out, g, e);
  return static_cast<int>(cudaGetLastError());
}

// The float kernels: x and w each f32 or bf16.
template <template <typename> class MaskT, typename Make>
int launch_float(const void* x, const void* w, void* out, const int* dims,
                 const Epi& e, int x_bf16, int w_bf16, void* stream,
                 Make make) {
  using B = __nv_bfloat16;
  if (x_bf16 && w_bf16)
    return launch<B, B>(x, w, make(MaskT<B>{}), out, dims, e, stream);
  if (x_bf16)
    return launch<B, float>(x, w, make(MaskT<B>{}), out, dims, e, stream);
  if (w_bf16)
    return launch<float, B>(x, w, make(MaskT<float>{}), out, dims, e,
                            stream);
  return launch<float, float>(x, w, make(MaskT<float>{}), out, dims, e,
                              stream);
}

int masked_conv(const void* x, const void* w, const void* seeds,
                uint32_t thresh, const Epi& e, void* out, const int* dims,
                float scale, int x_bf16, int w_bf16, void* stream) {
  if (seeds == nullptr) {
    return launch_float<NoMask>(x, w, out, dims, e, x_bf16, w_bf16, stream,
                                [](auto m) { return m; });
  }
  const auto* sd = static_cast<const int32_t*>(seeds);
  return launch_float<HashMask>(
      x, w, out, dims, e, x_bf16, w_bf16, stream, [&](auto m) {
        m.seeds = sd;
        m.thresh = thresh;
        m.scale = scale;
        return m;
      });
}

int masked_conv_int8(const void* x, const void* w, const void* seeds,
                     uint32_t thresh, const Epi& e, void* out,
                     const int* dims, void* stream) {
  if (seeds == nullptr) {
    return launch<int8_t, int8_t>(x, w, NoMask<int8_t>{}, out, dims, e,
                                  stream);
  }
  HashMask<int8_t> m{};
  m.seeds = static_cast<const int32_t*>(seeds);
  m.thresh = thresh;
  return launch<int8_t, int8_t>(x, w, m, out, dims, e, stream);
}

int bank_conv(const void* x, const void* w, const void* bank,
              const void* idxs, int idx0, int num_masks, const Epi& e,
              void* out, const int* dims, int x_bf16, int w_bf16,
              void* stream) {
  const auto* b = static_cast<const float*>(bank);
  const auto* ix = static_cast<const int32_t*>(idxs);
  return launch_float<BankMask>(
      x, w, out, dims, e, x_bf16, w_bf16, stream, [&](auto m) {
        m.bank = b;
        m.idxs = ix;
        m.idx0 = idx0;
        m.n = num_masks;
        m.C = dims[3];
        return m;
      });
}

int bank_conv_int8(const void* x, const void* w, const void* bank,
                   const void* idxs, int idx0, int num_masks, const Epi& e,
                   void* out, const int* dims, void* stream) {
  BankMask<int8_t> m{};
  m.bank = static_cast<const float*>(bank);
  m.idxs = static_cast<const int32_t*>(idxs);
  m.idx0 = idx0;
  m.n = num_masks;
  m.C = dims[3];
  return launch<int8_t, int8_t>(x, w, m, out, dims, e, stream);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0
// on success); it neither allocates nor synchronises. Every entry ends in
// the same arguments:
//   affine   the (2, F) f32 [scale; bias] stack of the epilogue, or null;
//   out      (S, N, Ho, Wo, F) of out_kind's type;
//   dims     a host array (N, H, W, C, F, KH, KW, stride, pad_top,
//            pad_left, Ho, Wo, S); one sample is S = 1;
//   fscale   the dropout scale (float MC kernels: 1/(1 - rate) in x's
//            type), or out_scale (int8 kernels); unused by the float bank
//            kernels;
//   out_kind 0 f32, 1 bf16, 2 int8, and inv_step the f32 of 1 / out_step;
//   relu     nonzero for a relu after the affine;
//   x_bf16, w_bf16  the float kernels' element types (0: f32); unused by
//            the int8 kernels;
//   stream.
// The two MC entries, float and int8, serve one sample and S alike: they
// take `seeds` ((2,) for S = 1, (S, 2); null: no mask, for conv_fused and
// conv_int8_fused) and the keep threshold. The bank entries take the f32
// (num_masks, C) bank and an int index (single) or S int32 indices
// (samples).
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
  return masked_conv(x, w, seeds, thresh, BT_EPI(1.f), out, dims, fscale,
                     x_bf16, w_bf16, stream);
}

extern "C" int bt_masked_conv_int8(const void* x, const void* w,
                                   const void* seeds, uint32_t thresh,
                                   BT_TAIL) {
  return masked_conv_int8(x, w, seeds, thresh, BT_EPI(fscale), out, dims,
                          stream);
}

extern "C" int bt_bank_conv(const void* x, const void* w, const void* bank,
                            int idx, int num_masks, BT_TAIL) {
  return bank_conv(x, w, bank, nullptr, idx, num_masks, BT_EPI(1.f), out,
                   dims, x_bf16, w_bf16, stream);
}

extern "C" int bt_bank_conv_samples(const void* x, const void* w,
                                    const void* bank, const void* idxs,
                                    int num_masks, BT_TAIL) {
  return bank_conv(x, w, bank, idxs, 0, num_masks, BT_EPI(1.f), out, dims,
                   x_bf16, w_bf16, stream);
}

extern "C" int bt_bank_conv_int8(const void* x, const void* w,
                                 const void* bank, int idx, int num_masks,
                                 BT_TAIL) {
  return bank_conv_int8(x, w, bank, nullptr, idx, num_masks, BT_EPI(fscale),
                        out, dims, stream);
}

extern "C" int bt_bank_conv_int8_samples(const void* x, const void* w,
                                         const void* bank, const void* idxs,
                                         int num_masks, BT_TAIL) {
  return bank_conv_int8(x, w, bank, idxs, 0, num_masks, BT_EPI(fscale), out,
                        dims, stream);
}
