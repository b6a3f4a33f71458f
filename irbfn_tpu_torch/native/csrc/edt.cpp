// Exact 2D Euclidean distance transform (Felzenszwalb & Huttenlocher 2004,
// lower envelope of parabolas; two separable 1D passes).
//
// Native runtime piece of the occupancy-map loader (irbfn_tpu/sim/map.py):
// turns a binary free-space bitmap into the meters-to-nearest-obstacle field
// the device-side lidar sphere-traces — the role scipy's
// distance_transform_edt plays for the reference's scan simulator
// (deprecated/f1tenth_gym/gym/f110_gym/envs/laser_models.py:36-50).
// Independent implementation (this file shares no code with scipy); the
// scipy EDT remains as the cross-check oracle in tests/test_native.py.

#include <cstdint>
#include <cmath>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::max() / 4.0f;

// 1D squared-distance transform of sampled function f (length n) into d.
// v/z are scratch of length n and n+1. Parabola-intersection arithmetic is
// done in double: for dimensions of a few thousand cells q*q ~ 1e7 where
// f32 ulp ~ 1, so f32 intersection ordering can differ from the exact
// envelope (inputs/outputs stay f32 — the final distances are small).
void dt1d(const float* f, float* d, int* v, double* z, int64_t n) {
  constexpr double kInfD = std::numeric_limits<double>::infinity();
  int k = 0;
  v[0] = 0;
  z[0] = -kInfD;
  z[1] = kInfD;
  for (int64_t q = 1; q < n; ++q) {
    double s;
    const double fq = static_cast<double>(f[q]) + static_cast<double>(q) * q;
    for (;;) {
      int p = v[k];
      s = (fq - (static_cast<double>(f[p]) + static_cast<double>(p) * p)) /
          (2.0 * (q - p));
      if (s > z[k]) break;
      --k;
    }
    ++k;
    v[k] = static_cast<int>(q);
    z[k] = s;
    z[k + 1] = kInfD;
  }
  k = 0;
  for (int64_t q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    double dq = static_cast<double>(q) - v[k];
    d[q] = static_cast<float>(dq * dq + f[v[k]]);
  }
}

void columns_pass(float* g, int64_t h, int64_t w, int64_t c0, int64_t c1) {
  std::vector<float> f(h), d(h);
  std::vector<double> z(h + 1);
  std::vector<int> v(h);
  for (int64_t c = c0; c < c1; ++c) {
    for (int64_t r = 0; r < h; ++r) f[r] = g[r * w + c];
    dt1d(f.data(), d.data(), v.data(), z.data(), h);
    for (int64_t r = 0; r < h; ++r) g[r * w + c] = d[r];
  }
}

void rows_pass(float* g, float* out, int64_t h, int64_t w, float res,
               int64_t r0, int64_t r1) {
  std::vector<float> d(w);
  std::vector<double> z(w + 1);
  std::vector<int> v(w);
  for (int64_t r = r0; r < r1; ++r) {
    dt1d(g + r * w, d.data(), v.data(), z.data(), w);
    for (int64_t c = 0; c < w; ++c) out[r * w + c] = res * std::sqrt(d[c]);
  }
}

}  // namespace

extern "C" {

// free: (h, w) row-major, nonzero = free space. out: (h, w) f32 distance in
// meters from each cell to the nearest obstacle cell (0 inside obstacles).
void edt_f32(const uint8_t* free_cells, int64_t h, int64_t w,
             float resolution, float* out) {
  std::vector<float> g(static_cast<size_t>(h) * w);
  for (int64_t i = 0; i < h * w; ++i) g[i] = free_cells[i] ? kInf : 0.0f;

  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = hw ? static_cast<int64_t>(hw) : 4;
  if (nt > w) nt = w;
  if (nt > h) nt = h;
  if (nt < 1) nt = 1;

  {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < nt; ++t) {
      int64_t c0 = w * t / nt, c1 = w * (t + 1) / nt;
      ts.emplace_back(columns_pass, g.data(), h, w, c0, c1);
    }
    for (auto& th : ts) th.join();
  }
  {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < nt; ++t) {
      int64_t r0 = h * t / nt, r1 = h * (t + 1) / nt;
      ts.emplace_back(rows_pass, g.data(), out, h, w, resolution, r0, r1);
    }
    for (auto& th : ts) th.join();
  }
}

}  // extern "C"
