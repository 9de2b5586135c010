// Reference-equivalent compiled CPU baseline (VERDICT r3 item 4).
//
// A faithful C++17/OpenMP implementation of the NGD Gaussian-VI iteration
// on the bench chain-estimation problems, mirroring the reference's CPU
// execution model (hzyu17/GaussianVI): all-f64 dense small-block algebra
// (the reference is header-only Eigen MatrixXd), sparse-GH sigma-point
// quadrature per nonlinear factor, GBP chain covariance + logdet
// (GVI-GH-GBP-impl.h:246-342 algorithm), closed-form linear-factor
// gradients with the Isserlis-collapsed Hessian, exact block-Thomas
// natural-gradient solve, and the reference's SEQUENTIAL backtracking
// shrink loop (first accepted trial wins — early exit, which favors this
// baseline over the engine's evaluate-all-trials lockstep).  OpenMP
// parallelizes over problems — the batch analog of the reference's
// factor-level `#pragma omp parallel for` (ngd/NGD-GH-impl.h:31-51).
//
// NOT a copy of the reference (which cannot compile here: it requires
// Eigen 3.4, absent from this image with no egress) — an independent
// implementation of the same published math, built from this repo's own
// formulation to give bench.py a compiled-CPU denominator.
//
// Input: flat binary written by scripts/cpu_baseline.py.  Output: one line
//   <prob_iters_per_sec> <mean_final_cost>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int S = 4;       // state dim (pos2 + vel2)
constexpr int S2 = S * S;

using std::vector;

// ---- tiny dense helpers (column-agnostic row-major) ------------------------

// lower cholesky of n x n SPD in-place-free; returns false on non-SPD
bool chol(const double* a, double* l, int n) {
  for (int j = 0; j < n; ++j) {
    double acc = a[j * n + j];
    for (int k = 0; k < j; ++k) acc -= l[j * n + k] * l[j * n + k];
    if (!(acc > 0.0)) return false;
    double d = std::sqrt(acc);
    l[j * n + j] = d;
    double inv = 1.0 / d;
    for (int i = j + 1; i < n; ++i) {
      double s = a[i * n + j];
      for (int k = 0; k < j; ++k) s -= l[i * n + k] * l[j * n + k];
      l[i * n + j] = s * inv;
    }
    for (int i = 0; i < j; ++i) l[i * n + j] = 0.0;
  }
  return true;
}

void chol_solve_vec(const double* l, const double* b, double* x, int n) {
  double y[8];
  for (int i = 0; i < n; ++i) {
    double acc = b[i];
    for (int k = 0; k < i; ++k) acc -= l[i * n + k] * y[k];
    y[i] = acc / l[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double acc = y[i];
    for (int k = i + 1; k < n; ++k) acc -= l[k * n + i] * x[k];
    x[i] = acc / l[i * n + i];
  }
}

// inv(A) from its cholesky
void chol_inv(const double* l, double* inv, int n) {
  double e[8], col[8];
  for (int c = 0; c < n; ++c) {
    for (int i = 0; i < n; ++i) e[i] = (i == c) ? 1.0 : 0.0;
    chol_solve_vec(l, e, col, n);
    for (int i = 0; i < n; ++i) inv[i * n + c] = col[i];
  }
}

double logdet_from_chol(const double* l, int n) {
  double acc = 0.0;
  for (int j = 0; j < n; ++j) acc += std::log(l[j * n + j]);
  return 2.0 * acc;
}

void matmul(const double* a, const double* b, double* c, int n, int m,
            int p, bool ta = false) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < p; ++j) {
      double acc = 0.0;
      for (int k = 0; k < m; ++k)
        acc += (ta ? a[k * n + i] : a[i * m + k]) * b[k * p + j];
      c[i * p + j] = acc;
    }
}

struct Problem {
  // state
  vector<double> mu;        // [N][S]
  vector<double> pd;        // [N][S2]
  vector<double> po;        // [N-1][S2]
  // anchor (state 0)
  double a_lam[S2], a_pm[S], a_prec[S2], a_c;
  // min-acc edge prior (uniform)
  double e_lam[S * 2 * S], e_prec[S2], e_c;
  // range measurement per state
  vector<double> r, beacon, srq;   // [N], [N][dx], [N]
};

struct Shared {
  int64_t B, N, M, niters, ntrials, dx;
  double base, decay, temp, high_temp;
  vector<double> nodes, weights;   // [M][S], [M]
};

// chain sweeps: covd [N][S2], covo [N-1][S2], logdet; false if chol fails
bool chain(const Shared& sh, const vector<double>& pd,
           const vector<double>& po, vector<double>& covd,
           vector<double>& covo, double* logdet) {
  const int n = (int)sh.N;
  vector<double> fpiv(n * S2), gpiv(n * S2);
  double msg[S2] = {0}, l[S2], x[S], sol[S];
  double ld = 0.0;
  for (int i = 0; i < n; ++i) {
    double piv[S2];
    for (int t = 0; t < S2; ++t) piv[t] = pd[i * S2 + t] + msg[t];
    std::memcpy(&fpiv[i * S2], piv, sizeof piv);
    if (!chol(piv, l, S)) return false;
    ld += logdet_from_chol(l, S);
    if (i < n - 1) {
      const double* off = &po[i * S2];
      double xm[S2];
      for (int c = 0; c < S; ++c) {
        double b[S];
        for (int r2 = 0; r2 < S; ++r2) b[r2] = off[r2 * S + c];
        chol_solve_vec(l, b, sol, S);
        for (int r2 = 0; r2 < S; ++r2) xm[r2 * S + c] = sol[r2];
      }
      // msg = -off^T xm
      double m2[S2];
      matmul(off, xm, m2, S, S, S, /*ta=*/true);
      for (int t = 0; t < S2; ++t) msg[t] = -m2[t];
    }
  }
  *logdet = ld;
  std::memset(msg, 0, sizeof msg);
  for (int i = n - 1; i >= 0; --i) {
    double piv[S2];
    for (int t = 0; t < S2; ++t) piv[t] = pd[i * S2 + t] + msg[t];
    std::memcpy(&gpiv[i * S2], piv, sizeof piv);
    if (i > 0) {
      if (!chol(piv, l, S)) return false;
      const double* off = &po[(i - 1) * S2];
      double xm[S2];
      for (int c = 0; c < S; ++c) {
        double b[S];
        for (int r2 = 0; r2 < S; ++r2) b[r2] = off[c * S + r2];
        chol_solve_vec(l, b, sol, S);
        for (int r2 = 0; r2 < S; ++r2) xm[r2 * S + c] = sol[r2];
      }
      double m2[S2];
      matmul(&po[(i - 1) * S2], xm, m2, S, S, S);
      for (int t = 0; t < S2; ++t) msg[t] = -m2[t];
    }
  }
  // per-edge 2S x 2S joint inversion
  const int T = 2 * S, T2 = T * T;
  double joint[T2], lj[T2], inv[T2];
  for (int i = 0; i < n - 1; ++i) {
    const double* f = &fpiv[i * S2];
    const double* g = &gpiv[(i + 1) * S2];
    const double* off = &po[i * S2];
    for (int a = 0; a < S; ++a)
      for (int b = 0; b < S; ++b) {
        joint[a * T + b] = f[a * S + b];
        joint[a * T + S + b] = off[a * S + b];
        joint[(S + a) * T + b] = off[b * S + a];
        joint[(S + a) * T + S + b] = g[a * S + b];
      }
    if (!chol(joint, lj, T)) return false;
    chol_inv(lj, inv, T);
    for (int a = 0; a < S; ++a)
      for (int b = 0; b < S; ++b) {
        covd[i * S2 + a * S + b] = inv[a * T + b];
        covo[i * S2 + a * S + b] = inv[a * T + S + b];
        if (i == n - 2)
          covd[(n - 1) * S2 + a * S + b] = inv[(S + a) * T + S + b];
      }
  }
  return true;
}

// range cost phi at x (first dx components are position)
inline double phi_range(const double* x, const double* beacon, double r,
                        double srq, int dx) {
  double d2 = 1e-12;
  for (int j = 0; j < dx; ++j) {
    double d = x[j] - beacon[j];
    d2 += d * d;
  }
  double dist = std::sqrt(d2);
  double e = r - dist;
  return e * e / (2.0 * srq);
}

// quadrature: e_phi (+ optionally e_xmu, e_xxt) at marginal (mu_i, cov)
bool quad(const Shared& sh, const Problem& pr, int i, const double* mu_i,
          const double* cov, bool moments, double* e_phi, double* e_xmu,
          double* e_xxt) {
  double l[S2];
  if (!chol(cov, l, S)) return false;
  double ep = 0.0, exm[S] = {0}, exx[S2] = {0};
  const int dx = (int)sh.dx;
  for (int64_t m = 0; m < sh.M; ++m) {
    const double* xi = &sh.nodes[m * S];
    double diff[S], x[S];
    for (int a = 0; a < S; ++a) {
      double acc = 0.0;
      for (int k = 0; k <= a; ++k) acc += l[a * S + k] * xi[k];
      diff[a] = acc;
      x[a] = mu_i[a] + acc;
    }
    double w = sh.weights[m];
    double p = phi_range(x, &pr.beacon[i * dx], pr.r[i], pr.srq[i], dx);
    double wp = w * p;
    ep += wp;
    if (moments) {
      for (int a = 0; a < S; ++a) {
        exm[a] += wp * diff[a];
        for (int b = 0; b <= a; ++b) exx[a * S + b] += wp * diff[a] * diff[b];
      }
    }
  }
  *e_phi = ep;
  if (moments) {
    for (int a = 0; a < S; ++a) {
      e_xmu[a] = exm[a];
      for (int b = 0; b <= a; ++b) {
        e_xxt[a * S + b] = exx[a * S + b];
        e_xxt[b * S + a] = exx[a * S + b];
      }
    }
  }
  return true;
}

// total cost at (mu, pd, po); returns NaN on chol failure (rejected trial)
double total_cost(const Shared& sh, const Problem& pr,
                  const vector<double>& mu, const vector<double>& pd,
                  const vector<double>& po, vector<double>& covd,
                  vector<double>& covo, double* ld_out) {
  const int n = (int)sh.N;
  double ld;
  if (!chain(sh, pd, po, covd, covo, &ld))
    return std::nan("");
  double fc = 0.0;
  // nonlinear E[phi] per state
  for (int i = 0; i < n; ++i) {
    double ep;
    if (!quad(sh, pr, i, &mu[i * S], &covd[i * S2], false, &ep, nullptr,
              nullptr))
      return std::nan("");
    fc += ep;
  }
  // anchor: <A, Sig0> + resid^T prec resid, A = lam^T prec lam * C
  {
    double resid[S];
    for (int r2 = 0; r2 < S; ++r2) {
      double acc = -pr.a_pm[r2];
      for (int d = 0; d < S; ++d) acc += pr.a_lam[r2 * S + d] * mu[d];
      resid[r2] = acc;
    }
    double pl[S2], a[S2];
    matmul(pr.a_prec, pr.a_lam, pl, S, S, S);
    matmul(pr.a_lam, pl, a, S, S, S, /*ta=*/true);
    double tr = 0.0, q = 0.0;
    for (int t = 0; t < S2; ++t) tr += a[t] * covd[t];
    for (int r2 = 0; r2 < S; ++r2) {
      double row = 0.0;
      for (int c = 0; c < S; ++c) row += pr.a_prec[r2 * S + c] * resid[c];
      q += resid[r2] * row;
    }
    fc += (tr + q) * pr.a_c;
  }
  // min-acc edges: blockwise trace + residual quadratic
  {
    double pl[S * 2 * S], a[2 * S * 2 * S];
    matmul(pr.e_prec, pr.e_lam, pl, S, S, 2 * S);
    matmul(pr.e_lam, pl, a, 2 * S, S, 2 * S, /*ta=*/true);
    for (int i = 0; i < n - 1; ++i) {
      double tr = 0.0;
      for (int r2 = 0; r2 < S; ++r2)
        for (int c = 0; c < S; ++c) {
          tr += a[r2 * 2 * S + c] * covd[i * S2 + r2 * S + c];
          tr += a[(S + r2) * 2 * S + S + c] * covd[(i + 1) * S2 + r2 * S + c];
          tr += 2.0 * a[r2 * 2 * S + S + c] * covo[i * S2 + r2 * S + c];
        }
      double resid[S];
      for (int r2 = 0; r2 < S; ++r2) {
        double acc = 0.0;
        for (int d = 0; d < S; ++d) {
          acc += pr.e_lam[r2 * 2 * S + d] * mu[i * S + d];
          acc += pr.e_lam[r2 * 2 * S + S + d] * mu[(i + 1) * S + d];
        }
        resid[r2] = acc;
      }
      double q = 0.0;
      for (int r2 = 0; r2 < S; ++r2) {
        double row = 0.0;
        for (int c = 0; c < S; ++c) row += pr.e_prec[r2 * S + c] * resid[c];
        q += resid[r2] * row;
      }
      fc += (tr + q) * pr.e_c;
    }
  }
  *ld_out = ld;
  return fc;  // UNTEMPERED factor-cost sum; callers apply /T + 0.5 ld
}

// block-Thomas solve A x = b over (ad [N][S2], ao [N-1][S2]); false on fail
bool thomas(const Shared& sh, const vector<double>& ad,
            const vector<double>& ao, const vector<double>& b,
            vector<double>& x) {
  const int n = (int)sh.N;
  vector<double> piv(n * S2), y(n * S);
  double msg[S2] = {0}, l[S2], sol[S];
  for (int i = 0; i < n; ++i) {
    for (int t = 0; t < S2; ++t) piv[i * S2 + t] = ad[i * S2 + t] + msg[t];
    if (!chol(&piv[i * S2], l, S)) return false;
    if (i < n - 1) {
      const double* off = &ao[i * S2];
      double xm[S2], m2[S2];
      for (int c = 0; c < S; ++c) {
        double bb[S];
        for (int r2 = 0; r2 < S; ++r2) bb[r2] = off[r2 * S + c];
        chol_solve_vec(l, bb, sol, S);
        for (int r2 = 0; r2 < S; ++r2) xm[r2 * S + c] = sol[r2];
      }
      matmul(off, xm, m2, S, S, S, /*ta=*/true);
      for (int t = 0; t < S2; ++t) msg[t] = -m2[t];
    }
  }
  for (int i = 0; i < n; ++i) {
    for (int r2 = 0; r2 < S; ++r2) y[i * S + r2] = b[i * S + r2];
    if (i > 0) {
      double lprev[S2];
      if (!chol(&piv[(i - 1) * S2], lprev, S)) return false;
      chol_solve_vec(lprev, &y[(i - 1) * S], sol, S);
      const double* off = &ao[(i - 1) * S2];
      for (int r2 = 0; r2 < S; ++r2) {
        double acc = y[i * S + r2];
        for (int k = 0; k < S; ++k) acc -= off[k * S + r2] * sol[k];
        y[i * S + r2] = acc;
      }
    }
  }
  for (int i = n - 1; i >= 0; --i) {
    double rhs[S], l2[S2];
    for (int r2 = 0; r2 < S; ++r2) {
      double acc = y[i * S + r2];
      if (i < n - 1) {
        const double* off = &ao[i * S2];
        for (int c = 0; c < S; ++c) acc -= off[r2 * S + c] * x[(i + 1) * S + c];
      }
      rhs[r2] = acc;
    }
    if (!chol(&piv[i * S2], l2, S)) return false;
    chol_solve_vec(l2, rhs, &x[i * S], S);
  }
  return true;
}

// one full NGD run (niters iterations, sequential backtracking)
double run_problem(const Shared& sh, Problem& pr) {
  const int n = (int)sh.N;
  vector<double> covd(n * S2), covo((n - 1) * S2);
  vector<double> tcd(n * S2), tco((n - 1) * S2);
  double ld, temp = sh.temp;
  bool is_lowtemp = true;
  double fc = total_cost(sh, pr, pr.mu, pr.pd, pr.po, covd, covo, &ld);
  double cost = fc / temp + 0.5 * ld;
  vector<double> vdmu(n * S), vddd(n * S2), vddo((n - 1) * S2);
  vector<double> dmu(n * S), tmu(n * S), tpd(n * S2), tpo((n - 1) * S2);
  for (int64_t it = 0; it < sh.niters; ++it) {
    // gradients at the current iterate
    std::fill(vdmu.begin(), vdmu.end(), 0.0);
    std::fill(vddd.begin(), vddd.end(), 0.0);
    std::fill(vddo.begin(), vddo.end(), 0.0);
    double e_phi, e_xmu[S], e_xxt[S2], l[S2], p[S2];
    for (int i = 0; i < n; ++i) {
      if (!quad(sh, pr, i, &pr.mu[i * S], &covd[i * S2], true, &e_phi,
                e_xmu, e_xxt))
        return cost;  // unreachable-in-practice guard
      if (!chol(&covd[i * S2], l, S)) return cost;
      chol_inv(l, p, S);
      double pe[S2], pep[S2], sol[S];
      chol_solve_vec(l, e_xmu, sol, S);
      for (int a = 0; a < S; ++a) vdmu[i * S + a] += sol[a] / temp;
      matmul(p, e_xxt, pe, S, S, S);
      matmul(pe, p, pep, S, S, S);
      for (int a = 0; a < S; ++a)
        for (int b = 0; b < S; ++b)
          vddd[i * S2 + a * S + b] +=
              (0.5 * (pep[a * S + b] + pep[b * S + a]) - p[a * S + b] * e_phi)
              / temp;
    }
    // anchor gradients
    {
      double resid[S], w[S];
      for (int r2 = 0; r2 < S; ++r2) {
        double acc = -pr.a_pm[r2];
        for (int d = 0; d < S; ++d) acc += pr.a_lam[r2 * S + d] * pr.mu[d];
        resid[r2] = acc;
      }
      for (int r2 = 0; r2 < S; ++r2) {
        double acc = 0.0;
        for (int c = 0; c < S; ++c) acc += pr.a_prec[r2 * S + c] * resid[c];
        w[r2] = acc;
      }
      double pl[S2], a[S2];
      matmul(pr.a_prec, pr.a_lam, pl, S, S, S);
      matmul(pr.a_lam, pl, a, S, S, S, true);
      for (int d = 0; d < S; ++d) {
        double acc = 0.0;
        for (int r2 = 0; r2 < S; ++r2) acc += pr.a_lam[r2 * S + d] * w[r2];
        vdmu[d] += 2.0 * acc * pr.a_c / temp;
      }
      for (int t = 0; t < S2; ++t)
        vddd[t] += 2.0 * a[t] * pr.a_c / temp;
    }
    // edge gradients (uniform rows)
    {
      double pl[S * 2 * S], a[2 * S * 2 * S];
      matmul(pr.e_prec, pr.e_lam, pl, S, S, 2 * S);
      matmul(pr.e_lam, pl, a, 2 * S, S, 2 * S, true);
      for (int i = 0; i < n - 1; ++i) {
        double resid[S], w[S];
        for (int r2 = 0; r2 < S; ++r2) {
          double acc = 0.0;
          for (int d = 0; d < S; ++d) {
            acc += pr.e_lam[r2 * 2 * S + d] * pr.mu[i * S + d];
            acc += pr.e_lam[r2 * 2 * S + S + d] * pr.mu[(i + 1) * S + d];
          }
          resid[r2] = acc;
        }
        for (int r2 = 0; r2 < S; ++r2) {
          double acc = 0.0;
          for (int c = 0; c < S; ++c) acc += pr.e_prec[r2 * S + c] * resid[c];
          w[r2] = acc;
        }
        for (int d = 0; d < 2 * S; ++d) {
          double acc = 0.0;
          for (int r2 = 0; r2 < S; ++r2)
            acc += pr.e_lam[r2 * 2 * S + d] * w[r2];
          double g = 2.0 * acc * pr.e_c / temp;
          if (d < S) vdmu[i * S + d] += g;
          else vdmu[(i + 1) * S + d - S] += g;
        }
        for (int r2 = 0; r2 < S; ++r2)
          for (int c = 0; c < S; ++c) {
            double cc = 2.0 * pr.e_c / temp;
            vddd[i * S2 + r2 * S + c] += a[r2 * 2 * S + c] * cc;
            vddd[(i + 1) * S2 + r2 * S + c] +=
                a[(S + r2) * 2 * S + S + c] * cc;
            vddo[i * S2 + r2 * S + c] += a[r2 * 2 * S + S + c] * cc;
          }
      }
    }
    // natural-gradient solve (fallback to the current precision metric)
    vector<double> rhs(n * S);
    for (int t = 0; t < n * S; ++t) rhs[t] = -vdmu[t];
    bool ok = thomas(sh, vddd, vddo, rhs, dmu);
    if (!ok) ok = thomas(sh, pr.pd, pr.po, rhs, dmu);
    if (!ok) return cost;
    // sequential backtracking (reference shrink loop: first accept wins)
    bool accepted = false;
    for (int64_t t = 1; t <= sh.ntrials; ++t) {
      double step = sh.base * std::pow(sh.decay, (double)t);
      for (int i = 0; i < n; ++i)
        for (int d = 0; d < S; ++d)
          tmu[i * S + d] = pr.mu[i * S + d] + step * dmu[i * S + d];
      for (int i = 0; i < n; ++i)
        for (int a = 0; a < S; ++a)
          for (int b = 0; b < S; ++b) {
            double va = pr.pd[i * S2 + a * S + b]
                + step * (vddd[i * S2 + a * S + b]
                          - pr.pd[i * S2 + a * S + b]);
            double vb = pr.pd[i * S2 + b * S + a]
                + step * (vddd[i * S2 + b * S + a]
                          - pr.pd[i * S2 + b * S + a]);
            tpd[i * S2 + a * S + b] = 0.5 * (va + vb);
          }
      for (int i = 0; i < n - 1; ++i)
        for (int t2 = 0; t2 < S2; ++t2)
          tpo[i * S2 + t2] = pr.po[i * S2 + t2]
              + step * (vddo[i * S2 + t2] - pr.po[i * S2 + t2]);
      double tld;
      double tfc = total_cost(sh, pr, tmu, tpd, tpo, tcd, tco, &tld);
      double tc = tfc / temp + 0.5 * tld;
      if (tc < cost) {  // NaN compares false
        pr.mu.swap(tmu);
        pr.pd.swap(tpd);
        pr.po.swap(tpo);
        covd.swap(tcd);
        covo.swap(tco);
        cost = tc;
        fc = tfc;
        ld = tld;
        accepted = true;
        break;
      }
    }
    if (!accepted) {
      // reference GVI-GH-impl.h:100-115: escalate to the high temperature
      // once, converge only if already there
      if (is_lowtemp) {
        is_lowtemp = false;
        temp = sh.high_temp;
        cost = fc / temp + 0.5 * ld;
      } else {
        break;
      }
    }
  }
  return cost;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s problems.bin\n", argv[0]);
    return 2;
  }
  FILE* f = std::fopen(argv[1], "rb");
  if (!f) return 2;
  int64_t hdr[6];
  double cfg[4];
  if (std::fread(hdr, 8, 6, f) != 6 || std::fread(cfg, 8, 4, f) != 4)
    return 2;
  Shared sh;
  sh.B = hdr[0];
  sh.N = hdr[1];
  int64_t s = hdr[2];
  sh.M = hdr[3];
  sh.niters = hdr[4];
  sh.ntrials = hdr[5];
  sh.base = cfg[0];
  sh.decay = cfg[1];
  sh.temp = cfg[2];
  sh.high_temp = cfg[3];
  if (s != S) {
    std::fprintf(stderr, "state dim %lld != compiled %d\n",
                 (long long)s, S);
    return 2;
  }
  auto rd = [&](vector<double>& v, size_t count) {
    v.resize(count);
    if (std::fread(v.data(), 8, count, f) != count) std::abort();
  };
  rd(sh.nodes, sh.M * S);
  rd(sh.weights, sh.M);
  const int64_t B = sh.B, N = sh.N;
  vector<double> mu, pd, po, alam, apm, aprec, ac, elam, eprec, ec, rr, bc,
      srq;
  rd(mu, B * N * S);
  rd(pd, B * N * S2);
  rd(po, B * (N - 1) * S2);
  rd(alam, B * S2);
  rd(apm, B * S);
  rd(aprec, B * S2);
  rd(ac, B);
  rd(elam, B * S * 2 * S);
  rd(eprec, B * S2);
  rd(ec, B);
  rd(rr, B * N);
  int64_t dx_probe;
  // beacon needs dx which is stored at the END; read the remainder greedily
  long pos = std::ftell(f);
  std::fseek(f, -8, SEEK_END);
  if (std::fread(&dx_probe, 8, 1, f) != 1) return 2;
  sh.dx = dx_probe;
  std::fseek(f, pos, SEEK_SET);
  rd(bc, B * N * sh.dx);
  rd(srq, B * N);
  std::fclose(f);

  vector<Problem> probs(B);
  for (int64_t b = 0; b < B; ++b) {
    Problem& p = probs[b];
    p.mu.assign(&mu[b * N * S], &mu[(b + 1) * N * S]);
    p.pd.assign(&pd[b * N * S2], &pd[(b + 1) * N * S2]);
    p.po.assign(&po[b * (N - 1) * S2], &po[(b + 1) * (N - 1) * S2]);
    std::memcpy(p.a_lam, &alam[b * S2], sizeof p.a_lam);
    std::memcpy(p.a_pm, &apm[b * S], sizeof p.a_pm);
    std::memcpy(p.a_prec, &aprec[b * S2], sizeof p.a_prec);
    p.a_c = ac[b];
    std::memcpy(p.e_lam, &elam[b * S * 2 * S], sizeof p.e_lam);
    std::memcpy(p.e_prec, &eprec[b * S2], sizeof p.e_prec);
    p.e_c = ec[b];
    p.r.assign(&rr[b * N], &rr[(b + 1) * N]);
    p.beacon.assign(&bc[b * N * sh.dx], &bc[(b + 1) * N * sh.dx]);
    p.srq.assign(&srq[b * N], &srq[(b + 1) * N]);
  }

  // warm pass (first-touch, page faults) then timed passes
  vector<Problem> work = probs;
  vector<double> final_costs(B);
  double t0, best = 1e300;
#ifdef _OPENMP
  t0 = omp_get_wtime();
#else
  t0 = 0.0;
#endif
  for (int rep = 0; rep < 3; ++rep) {
    work = probs;
#ifdef _OPENMP
    double tr = omp_get_wtime();
#pragma omp parallel for schedule(dynamic)
    for (int64_t b = 0; b < B; ++b) final_costs[b] = run_problem(sh, work[b]);
    double dt = omp_get_wtime() - tr;
#else
    for (int64_t b = 0; b < B; ++b) final_costs[b] = run_problem(sh, work[b]);
    double dt = 1.0;
#endif
    if (dt < best) best = dt;
  }
  if (argc > 2 && std::strcmp(argv[2], "-v") == 0) {
    for (int64_t b = 0; b < B; ++b) {
      vector<double> cd(N * S2), co((N - 1) * S2);
      double ld;
      Problem pi = probs[b];
      double fc0 = total_cost(sh, pi, pi.mu, pi.pd, pi.po, cd, co, &ld);
      std::printf("  problem %lld: init %.6f final %.6f\n", (long long)b,
                  fc0 / sh.temp + 0.5 * ld, final_costs[b]);
    }
  }
  double mean = 0.0;
  for (int64_t b = 0; b < B; ++b) mean += final_costs[b] / (double)B;
  std::printf("%.1f prob-iters/s  mean_final_cost=%.6f\n",
              (double)B * (double)sh.niters / best, mean);
  return 0;
}
