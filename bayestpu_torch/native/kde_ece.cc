// Native host-side KDE-ECE finalizer.
//
// The reference's KDE ECE (Software_Artifact/software/train/
// results_analyzer.py:351-443, Mix-n-Match estimator via KDEpy FFTKDE) is
// the hot host-side metric: a triweight-kernel KDE of (a) confidences of
// correct predictions and (b) all confidences on a 2^14-point grid, then a
// reliability integral. bayestpu/metrics/kde.py is the reference Python
// implementation; this C++ version is the production path for large
// prediction sets (the multipass 1..49 sweep evaluates it dozens of times
// per run). Exact same algorithm: linear binning, direct convolution with
// the triweight kernel (KDEpy bw convention: bw = kernel stddev, so support
// half-width = 3*bw), reflecting boundaries, forward-fill, trapezoid
// integration.
//
// C ABI only (called through ctypes) — no Python/numpy headers needed.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kGridN = 1 << 14;
constexpr double kGridLo = -0.6;
constexpr double kGridHi = 1.6;

// Linear binning of samples onto the uniform grid.
void bin_linear(const std::vector<double>& data, std::vector<double>* hist) {
  const double dx = (kGridHi - kGridLo) / (kGridN - 1);
  for (double v : data) {
    double pos = (v - kGridLo) / dx;
    int64_t i0 = static_cast<int64_t>(std::floor(pos));
    i0 = std::max<int64_t>(0, std::min<int64_t>(i0, kGridN - 2));
    double frac = pos - static_cast<double>(i0);
    (*hist)[i0] += 1.0 - frac;
    (*hist)[i0 + 1] += frac;
  }
}

// Triweight KDE by direct convolution (kernel support is small relative to
// the grid, so O(n_grid * kernel_width) beats an FFT at this size).
void kde_triweight(const std::vector<double>& data, double bw,
                   std::vector<double>* out) {
  const double dx = (kGridHi - kGridLo) / (kGridN - 1);
  std::vector<double> hist(kGridN, 0.0);
  bin_linear(data, &hist);
  const double half = 3.0 * bw;
  const int m = std::max<int>(1, static_cast<int>(std::ceil(half / dx)));
  std::vector<double> kern(2 * m + 1);
  for (int j = -m; j <= m; ++j) {
    double u = (j * dx) / half;
    kern[j + m] = std::abs(u) <= 1.0
        ? (35.0 / 32.0) * std::pow(1.0 - u * u, 3) / half : 0.0;
  }
  out->assign(kGridN, 0.0);
  const double inv_n = 1.0 / static_cast<double>(data.size());
  for (int i = 0; i < kGridN; ++i) {
    double h = hist[i];
    if (h == 0.0) continue;
    int lo = std::max(0, i - m), hi = std::min(kGridN - 1, i + m);
    for (int j = lo; j <= hi; ++j) (*out)[j] += h * kern[j - i + m];
  }
  for (double& v : *out) v = std::max(v * inv_n, 0.0);
}

// Reflecting boundary conditions (results_analyzer.py:339-349).
std::vector<double> mirror(const std::vector<double>& d) {
  std::vector<double> out;
  out.reserve(2 * d.size());
  for (double v : d) if (v < 0.5) out.push_back(-v);
  for (double v : d) out.push_back(v);
  for (double v : d) if (v >= 0.5) out.push_back(2.0 - v);
  return out;
}

double trapz(const std::vector<double>& y, const std::vector<double>& x,
             int lo, int hi) {
  double acc = 0.0;
  for (int i = lo + 1; i <= hi; ++i)
    acc += 0.5 * (y[i] + y[i - 1]) * (x[i] - x[i - 1]);
  return acc;
}

}  // namespace

extern "C" {

// conf: top-1 confidences (renormalized), correct: 0/1 per sample.
// Returns the KDE ECE; negative value on error.
double bayestpu_kde_ece(const double* conf, const uint8_t* correct,
                        int64_t n, int order) {
  if (n <= 0) return -1.0;
  std::vector<double> all(conf, conf + n);
  std::vector<double> corr;
  corr.reserve(n);
  int64_t n_correct = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (correct[i]) { corr.push_back(conf[i]); ++n_correct; }
  }
  // bandwidth: std of correct-confidences * (2N)^(-1/5)  (:383-388)
  double kbw;
  if (!corr.empty()) {
    double mean = 0.0;
    for (double v : corr) mean += v;
    mean /= corr.size();
    double var = 0.0;
    for (double v : corr) var += (v - mean) * (v - mean);
    var /= corr.size();
    double sd = std::sqrt(var);
    kbw = (sd != 0.0 ? sd : 1e-16) * std::pow(2.0 * n, -0.2);
  } else {
    kbw = 1e-16 * std::pow(2.0 * n, -0.2);
  }

  std::vector<double> x_int(kGridN);
  const double dx = (kGridHi - kGridLo) / (kGridN - 1);
  for (int i = 0; i < kGridN; ++i) x_int[i] = kGridLo + i * dx;

  std::vector<double> pp1, pp2;
  kde_triweight(mirror(corr), kbw, &pp1);
  kde_triweight(mirror(all), kbw, &pp2);
  for (int i = 0; i < kGridN; ++i) {
    bool inside = x_int[i] > 0.0 && x_int[i] < 1.0;
    pp1[i] = inside ? pp1[i] * 2.0 : 0.0;
    pp2[i] = inside ? pp2[i] * 2.0 : 0.0;
  }

  const double perc = static_cast<double>(n_correct) / n;
  std::vector<double> integral(kGridN, 0.0);
  for (int i = 0; i < kGridN; ++i) {
    if (std::max(pp1[i], pp2[i]) > 1e-6) {
      double accu = std::min(perc * pp1[i] / pp2[i], 1.0);
      if (!std::isnan(accu)) {
        integral[i] = std::pow(std::abs(x_int[i] - accu), order) * pp2[i];
        continue;
      }
    }
    if (i > 1) integral[i] = integral[i - 1];  // forward-fill (:437-439)
  }

  int lo = 0, hi = kGridN - 1;
  while (lo < kGridN && x_int[lo] < 0.0) ++lo;
  while (hi > 0 && x_int[hi] > 1.0) --hi;
  double denom = trapz(pp2, x_int, lo, hi);
  if (denom <= 0.0) return 0.0;
  return trapz(integral, x_int, lo, hi) / denom;
}

int bayestpu_native_abi_version() { return 1; }

}  // extern "C"
