// Native host-side data pipeline: fused gather + pad-crop + h-flip +
// normalize, OpenMP-threaded over the batch.
//
// TPU-native counterpart of the reference's host input pipelines — the
// torchvision transform stack (RandomCrop(32, padding=4) +
// RandomHorizontalFlip + Normalize, Software_Artifact/software/datasets/
// dataset_loader.py:103-108) and the Keras ImageDataGenerator shifts/flips
// (Hardware_Artifact/bayes_hw/train_qkeras.py:152-160). Those run one
// Python-object transform per image per epoch; here one C call assembles a
// whole training batch in a single pass over the source array: no
// intermediate padded copies, no per-image Python dispatch, all cores.
//
// Determinism: augmentation decisions derive from splitmix64(seed, i) per
// batch row, so the Python fallback (bayestpu/data/pipeline.py) reproduces
// the exact same crops/flips bit-for-bit. This mirrors the framework-wide
// rule that every native/kernels fast path has a pure reference twin.

#include <cstdint>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

// src: (n, h, w, c) float32 in [0,1] (or any range; normalize is affine).
// idx: (b,) int64 row indices into src (the shuffled batch).
// out: (b, h, w, c) float32, written fully.
// mean/stdv: (c,) per-channel normalize stats; pass 0/1 for identity.
// pad: crop padding radius (0 disables crop+flip entirely).
// train: 0 → pure gather+normalize (eval path), 1 → augment.
void bayestpu_augment_gather(const float* src, const int64_t* idx, float* out,
                             int64_t b, int64_t h, int64_t w, int64_t c,
                             const float* mean, const float* stdv, int pad,
                             uint64_t seed, int train) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < b; ++i) {
    const float* img = src + idx[i] * h * w * c;
    float* o = out + i * h * w * c;
    int oy = 0, ox = 0, flip = 0;
    if (train && pad > 0) {
      uint64_t r = splitmix64(seed ^ ((uint64_t)i * 0x9E3779B97F4A7C15ULL));
      oy = (int)(r % (uint64_t)(2 * pad + 1));
      uint64_t r2 = splitmix64(r);
      ox = (int)(r2 % (uint64_t)(2 * pad + 1));
      flip = (int)(splitmix64(r2) & 1ULL);
    }
    for (int64_t y = 0; y < h; ++y) {
      const int64_t sy = y + oy - (train ? pad : 0);
      for (int64_t x = 0; x < w; ++x) {
        const int64_t sx = x + ox - (train ? pad : 0);
        const int64_t tx = flip ? (w - 1 - x) : x;
        const bool in = sy >= 0 && sy < h && sx >= 0 && sx < w;
        const float* s = img + (sy * w + sx) * c;
        float* d = o + (y * w + tx) * c;
        for (int64_t ch = 0; ch < c; ++ch) {
          const float v = in ? s[ch] : 0.0f;
          d[ch] = (v - mean[ch]) / stdv[ch];
        }
      }
    }
  }
}

}  // extern "C"
