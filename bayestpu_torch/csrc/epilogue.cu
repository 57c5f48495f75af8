// The bf16 epilogue of a conv without a mask at inference, in one pass, for
// Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel. In a bf16 float model at inference a conv without
// a mask is XLA's conv in the JAX package (cuDNN here), and what follows it
// (bayestpu/nn/fused.py:465-474: the conv rounded to bf16, widened, plus the
// f32 bias of the folded BatchNorm, relu, stored as bf16; at a residual
// block's end bayestpu/nn/zoo/resnet.py's relu(y + residual) in bf16) is
// left to XLA, which fuses it into one loop. PyTorch runs it as five
// elementwise kernels over f32 copies: 28 bytes an element after a relu
// conv, 10 more for the residual. This kernel reads the conv's bf16 output
// once and writes bf16 once, with the same roundings in the same order:
//   t = f32(y) + bias[c]            (__fadd_rn; no add without a bias)
//   t = relu(t)                     (when asked)
//   o = bf16_rn(t)
//   o = bf16_rn(relu(f32(o) + f32(r)))   (with a residual r: PyTorch's bf16
//                                         add, then relu; both roundings)
// relu keeps a NaN as torch.relu does. y, the residual and out are (rows, C)
// row-major: NCHW tensors (or (S, N, C, H, W)) in channels_last memory, the
// channel innermost; the bias is f32 (C,).
//
// What bounds it on an H100: HBM bytes, 4 an element (bf16 in, bf16 out), 6
// with the residual; at resnet50's 47 convs of a block-site predict (batch
// 128, S = 10) 6.42 G elements, 34 GB, 10.2 ms at 3.35 TB/s. So every access
// is 16 bytes (8 bf16) a thread where C % 8 == 0 and the pointers are 16-byte
// aligned (one element a thread step otherwise), each thread keeps two such
// loads in flight, and a grid-stride loop over a grid of two waves of the
// 132 SMs at full occupancy holds enough bytes in flight to cover HBM's
// latency. When the grid's stride is a multiple of C (every power of two up
// to 2,048 channels), a thread's 8 channels stay the same through its loop,
// and it reads their bias once, through the read-only path. No allocation,
// no synchronisation: capturable in a CUDA graph.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;   // 2,048 threads: a full SM
constexpr int WAVES = 2;
constexpr int VEC = 8;             // bf16 in 16 bytes
constexpr int UNROLL = 2;          // 16-byte loads in flight a thread

// relu as torch.relu: NaN stays NaN
__device__ __forceinline__ float relu_f(float v) { return v < 0.f ? 0.f : v; }

template <bool HasBias, bool Relu, bool HasRes>
__device__ __forceinline__ __nv_bfloat16 epi(__nv_bfloat16 y, float b,
                                             __nv_bfloat16 r) {
  float t = __bfloat162float(y);
  if (HasBias) t = __fadd_rn(t, b);
  if (Relu) t = relu_f(t);
  __nv_bfloat16 o = __float2bfloat16_rn(t);
  if (HasRes)
    o = __float2bfloat16_rn(
        relu_f(__fadd_rn(__bfloat162float(o), __bfloat162float(r))));
  return o;
}

__device__ __forceinline__ void load_bias(float (&b)[VEC],
                                          const float* __restrict__ bias,
                                          long long c0) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(bias + c0));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(bias + c0) + 1);
  b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
  b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
}

// vec: 8 elements a step, n % 8 == 0, C % 8 == 0, pointers 16-byte aligned;
// else one element a step
template <bool HasBias, bool Relu, bool HasRes>
__global__ void __launch_bounds__(THREADS) bf16_epilogue_kernel(
    const __nv_bfloat16* __restrict__ y, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    long long n, int C, int vec) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  long long j = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (!vec) {
    for (; j < n; j += step)
      out[j] = epi<HasBias, Relu, HasRes>(
          y[j], HasBias ? __ldg(bias + j % C) : 0.f,
          HasRes ? res[j] : y[j]);
    return;
  }
  const long long n8 = n / VEC;
  const uint4* y8 = reinterpret_cast<const uint4*>(y);
  const uint4* r8 = reinterpret_cast<const uint4*>(res);
  uint4* o8 = reinterpret_cast<uint4*>(out);
  // the channels of chunk j are (8j mod C) .. + 7; with a stride that is a
  // multiple of C they are the thread's for the whole loop
  const bool fixed = (step * VEC) % C == 0;
  float b[VEC] = {};
  if (HasBias && fixed && j < n8) load_bias(b, bias, (j * VEC) % C);
  for (; j < n8; j += UNROLL * step) {
    alignas(16) __nv_bfloat16 v[UNROLL][VEC], r[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long k = j + u * step;
      if (k < n8) {
        *reinterpret_cast<uint4*>(v[u]) = y8[k];
        if (HasRes) *reinterpret_cast<uint4*>(r[u]) = r8[k];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long k = j + u * step;
      if (k >= n8) break;
      if (HasBias && !fixed) load_bias(b, bias, (k * VEC) % C);
      alignas(16) __nv_bfloat16 o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[e] = epi<HasBias, Relu, HasRes>(v[u][e], b[e],
                                          HasRes ? r[u][e] : v[u][e]);
      o8[k] = *reinterpret_cast<const uint4*>(o);
    }
  }
}

template <bool HasBias, bool Relu, bool HasRes>
int launch(const void* y, const void* bias, const void* res, void* out,
           long long n, int C, cudaStream_t st) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = C % VEC == 0 && aligned(y) && aligned(out) &&
                   (!HasRes || aligned(res)) && (!HasBias || aligned(bias));
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long per_thread = vec ? VEC * UNROLL : 1;
  const long long want = (n + per_thread * THREADS - 1) /
                         (per_thread * THREADS);
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM * WAVES;
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap));
  bf16_epilogue_kernel<HasBias, Relu, HasRes><<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), n, C, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <bool HasBias, bool Relu>
int launch_res(const void* y, const void* bias, const void* res, void* out,
               long long n, int C, cudaStream_t st) {
  return res ? launch<HasBias, Relu, true>(y, bias, res, out, n, C, st)
             : launch<HasBias, Relu, false>(y, bias, res, out, n, C, st);
}

}  // namespace

// y (rows, C) bf16, the conv's output; bias f32 (C,) or null; residual
// (rows, C) bf16 or null; out (rows, C) bf16, not aliasing y or the
// residual; relu 0 or 1; stream. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int bt_bias_act_bf16(const void* y, const void* bias,
                                const void* residual, void* out, int rows,
                                int C, int relu, void* stream) {
  const long long n = static_cast<long long>(rows) * C;
  if (n == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (bias)
    return relu ? launch_res<true, true>(y, bias, residual, out, n, C, st)
                : launch_res<true, false>(y, bias, residual, out, n, C, st);
  return relu ? launch_res<false, true>(y, bias, residual, out, n, C, st)
              : launch_res<false, false>(y, bias, residual, out, n, C, st);
}
