// Native batched SSN fixed-point solver (CPU reference / baseline path).
//
// Reference parity: the OpenMP C solver of tc_gan/ext/ (SURVEY.md §2 "C SSN
// solver", §3.4): batch-parallel forward Euler iteration of
//     r <- r + (dt/tau) * (-r + f(W r + I)),   f(u) = k * relu(u)^n
// with per-sample convergence (max-abs residual < atol) and divergence
// (rate ceiling) detection.
//
// Role in this repo: (a) the reference-equivalent float64 CPU solver that
// chip_smoke.py checks the GPU paths against, and (b) a third
// implementation for the cross-implementation consistency tests
// (SURVEY.md §4). The production path is ops/fixed_point.py + the Pallas
// kernel; this file is NOT on the device execution path.
//
// Build: `make -C csrc` -> libssnode.so, loaded via ctypes
// (tcgan_tpu/ops/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// io types (keep ids in sync with tcgan_tpu/ops/native.py)
constexpr int IO_ASYM_POWER = 0;
constexpr int IO_ASYM_TANH = 1;
constexpr int IO_ASYM_LINEAR = 2;

struct IoParams {
  int type;
  double k, n, r0, r1;
  double u0, slope;  // precomputed for asym_linear
};

inline double io_apply(const IoParams &io, double u) {
  double up = u > 0.0 ? u : 0.0;
  double fp = io.k * std::pow(up, io.n);
  switch (io.type) {
    case IO_ASYM_POWER:
      return fp;
    case IO_ASYM_TANH: {
      if (fp <= io.r0) return fp;
      double d = io.r1 - io.r0;
      return io.r0 + d * std::tanh((fp - io.r0) / d);
    }
    case IO_ASYM_LINEAR: {
      if (u <= io.u0) return fp;
      return io.r0 + io.slope * (u - io.u0);
    }
  }
  return fp;
}

}  // namespace

extern "C" {

// Solve a batch of SSN fixed points.
//
// W:    [batch, n2, n2] row-major (post x pre)
// I:    [batch, n_stim, n2]
// r:    [batch, n_stim, n2]  in: initial rates; out: final rates
// tau:  [n2]
// flags_out: [batch, n_stim]  0 = unconverged, 1 = converged, 2 = diverged
// iters_out: [batch, n_stim]  iterations consumed
//
// Returns number of converged (sample, stim) pairs.
int64_t ssnode_solve_batch(
    const double *W, const double *I, double *r, const double *tau,
    int64_t batch, int64_t n_stim, int64_t n2,
    double dt, int io_type, double k, double n, double r0, double r1,
    int64_t max_iter, double atol, double rate_stop_at,
    int32_t *flags_out, int32_t *iters_out) {
  IoParams io{io_type, k, n, r0, r1, 0.0, 0.0};
  if (io_type == IO_ASYM_LINEAR) {
    io.u0 = std::pow(r0 / k, 1.0 / n);
    io.slope = k * n * std::pow(io.u0, n - 1.0);
  }

  int64_t n_conv = 0;
#ifdef _OPENMP
#pragma omp parallel for collapse(2) reduction(+ : n_conv) schedule(dynamic)
#endif
  for (int64_t b = 0; b < batch; ++b) {
    for (int64_t s = 0; s < n_stim; ++s) {
      const double *Wb = W + b * n2 * n2;
      const double *Is = I + (b * n_stim + s) * n2;
      double *rs = r + (b * n_stim + s) * n2;
      std::vector<double> u(n2);
      int32_t flag = 0;
      int64_t it = 0;
      for (; it < max_iter; ++it) {
        // u = W r + I
        for (int64_t i = 0; i < n2; ++i) {
          const double *Wrow = Wb + i * n2;
          double acc = Is[i];
          for (int64_t j = 0; j < n2; ++j) acc += Wrow[j] * rs[j];
          u[i] = acc;
        }
        double max_resid = 0.0, max_rate = 0.0;
        for (int64_t i = 0; i < n2; ++i) {
          double delta = -rs[i] + io_apply(io, u[i]);
          rs[i] += (dt / tau[i]) * delta;
          double ad = std::fabs(delta);
          if (ad > max_resid) max_resid = ad;
          if (rs[i] > max_rate) max_rate = rs[i];
        }
        if (max_rate > rate_stop_at) {
          flag = 2;
          ++it;
          break;
        }
        if (max_resid < atol) {
          flag = 1;
          ++it;
          break;
        }
      }
      flags_out[b * n_stim + s] = flag;
      iters_out[b * n_stim + s] = static_cast<int32_t>(it);
      if (flag == 1) ++n_conv;
    }
  }
  return n_conv;
}

// Number of OpenMP threads the solver will use (for bench reporting).
int32_t ssnode_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
