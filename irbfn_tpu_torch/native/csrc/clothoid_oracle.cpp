// Clothoid G1-Hermite oracle (CPU, f64) — independent reference solver.
//
// Role: the pyclothoids C++ library is the reference's ground-truth BVP
// solver (deprecated/genlut.py:58). This oracle re-derives the same
// G1-Hermite fit from first principles (normalized-angle reduction + Newton
// on the y-endpoint integral, Gauss-Legendre quadrature) so the JAX solver
// can be validated against an implementation that shares NO code or
// numerical kernels with it. Exposed via a C ABI for ctypes.
//
// Build: irbfn_tpu_torch/native/__init__.py compiles this file with
// table_io.cpp and edt.cpp into build/native/ on first use (g++).

#include <cmath>
#include <cstdint>

namespace {

constexpr int kGaussOrder = 12;
constexpr int kSegments = 8;

// 12-point Gauss-Legendre nodes/weights on [-1, 1]
constexpr double kGx[kGaussOrder] = {
    -0.9815606342467192, -0.9041172563704749, -0.7699026741943047,
    -0.5873179542866175, -0.3678314989981802, -0.1252334085114689,
    0.1252334085114689,  0.3678314989981802,  0.5873179542866175,
    0.7699026741943047,  0.9041172563704749,  0.9815606342467192};
constexpr double kGw[kGaussOrder] = {
    0.0471753363865118, 0.1069393259953184, 0.1600783285433462,
    0.2031674267230659, 0.2334925365383548, 0.2491470458134028,
    0.2491470458134028, 0.2334925365383548, 0.2031674267230659,
    0.1600783285433462, 0.1069393259953184, 0.0471753363865118};

double wrap_angle(double a) {
  return a - 2.0 * M_PI * std::floor((a + M_PI) / (2.0 * M_PI));
}

// integral of {cos, sin}(phi0 + (delta - a/2) t + (a/2) t^2) over t in [0,1]
void xy_integrals(double a, double phi0, double delta, double* X, double* Y) {
  const double b = delta - 0.5 * a;
  double cx = 0.0, cy = 0.0;
  for (int s = 0; s < kSegments; ++s) {
    const double t0 = static_cast<double>(s) / kSegments;
    const double t1 = static_cast<double>(s + 1) / kSegments;
    const double half = 0.5 * (t1 - t0);
    const double mid = 0.5 * (t0 + t1);
    for (int i = 0; i < kGaussOrder; ++i) {
      const double t = mid + half * kGx[i];
      const double phase = phi0 + b * t + 0.5 * a * t * t;
      const double w = half * kGw[i];
      cx += w * std::cos(phase);
      cy += w * std::sin(phase);
    }
  }
  *X = cx;
  *Y = cy;
}

double dy_da(double a, double phi0, double delta) {
  const double b = delta - 0.5 * a;
  double acc = 0.0;
  for (int s = 0; s < kSegments; ++s) {
    const double t0 = static_cast<double>(s) / kSegments;
    const double t1 = static_cast<double>(s + 1) / kSegments;
    const double half = 0.5 * (t1 - t0);
    const double mid = 0.5 * (t0 + t1);
    for (int i = 0; i < kGaussOrder; ++i) {
      const double t = mid + half * kGx[i];
      const double phase = phi0 + b * t + 0.5 * a * t * t;
      acc += half * kGw[i] * std::cos(phase) * 0.5 * (t * t - t);
    }
  }
  return acc;
}

}  // namespace

extern "C" {

// Solve start(0,0,th0) -> goal(x,y,th1). Outputs [k0, dk, L]; returns 0 on
// success, nonzero on failure (degenerate / non-converged).
int clothoid_g1_solve(double x0, double y0, double th0, double x1, double y1,
                      double th1, double* out_k0, double* out_dk,
                      double* out_len) {
  const double dx = x1 - x0, dy = y1 - y0;
  const double r = std::hypot(dx, dy);
  if (r < 1e-12) {
    *out_k0 = 0.0;
    *out_dk = 0.0;
    *out_len = 0.0;
    return 1;
  }
  const double phi = std::atan2(dy, dx);
  const double phi0 = wrap_angle(th0 - phi);
  const double phi1 = wrap_angle(th1 - phi);
  const double delta = phi1 - phi0;

  double a = 6.0 * (phi0 + phi1);  // small-angle closed-form init
  double X, Y;
  for (int it = 0; it < 100; ++it) {
    xy_integrals(a, phi0, delta, &X, &Y);
    if (std::fabs(Y) < 1e-14) break;
    double d = dy_da(a, phi0, delta);
    if (std::fabs(d) < 1e-14) d = (d < 0 ? -1e-14 : 1e-14);
    double step = Y / d;
    if (step > 10.0) step = 10.0;
    if (step < -10.0) step = -10.0;
    a -= step;
  }
  xy_integrals(a, phi0, delta, &X, &Y);
  if (std::fabs(Y) > 1e-10 || std::fabs(X) < 1e-12) return 2;

  const double L = r / X;
  if (L < 0.0) return 3;
  *out_len = L;
  *out_k0 = (delta - 0.5 * a) / L;
  *out_dk = a / (L * L);
  return 0;
}

// Batched: goals (n, 3) row-major [x, y, theta]; out (n, 5) [k0,k1,k2,k3,s];
// status (n,). Start pose is the origin (the LUT convention).
void clothoid_g1_solve_batch(const double* goals, int64_t n, double* out,
                             int32_t* status) {
  for (int64_t i = 0; i < n; ++i) {
    double k0, dk, L;
    const int rc = clothoid_g1_solve(0.0, 0.0, 0.0, goals[3 * i],
                                     goals[3 * i + 1], goals[3 * i + 2], &k0,
                                     &dk, &L);
    status[i] = rc;
    out[5 * i + 0] = k0;
    out[5 * i + 1] = k0 + dk * L / 3.0;
    out[5 * i + 2] = k0 + 2.0 * dk * L / 3.0;
    out[5 * i + 3] = k0 + dk * L;
    out[5 * i + 4] = L;
  }
}

}  // extern "C"
