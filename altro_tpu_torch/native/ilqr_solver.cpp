// ilqr_solver.cpp — AL-iLQR conic trajectory optimizer, native C++.
//
// CPU-latency twin of altro_tpu/solver/altro.py (the TPU solver): same flat
// AL+iLQR algorithm — augmented-Lagrangian outer bookkeeping folded into a
// single iteration loop, backtracking line search with a trailing alpha=0
// cost, exact-model early stop, polar-cone dual updates — specialized to
// the reference problem class (LTV dynamics, quadratic cost, affine conic
// constraint blocks in ZERO/NONPOS/SOC).
//
// Why it exists: the reference's single-instance latency numbers time a
// compiled native solver (Altro.jl with StaticArrays, ~0.58 ms per warm
// solve at N=31 — figures/horizon_comp.tikz), while the JAX solver's CPU
// step pays ~1 ms/iteration + ~1 ms/step of XLA:CPU per-op dispatch at
// B=1 (tools/exp_single_latency.py: scan unrolling does NOT recover it —
// the overhead is per-HLO-op, not per-scan-step). This file is the honest
// native counterpart for the CPU latency row, exactly as
// native/knot_solver.cpp is for the OSQP/ECOS roles. The TPU path is
// unaffected: batched throughput still runs the JAX/Pallas solver.
//
// Algorithm parity is with solver/altro.py's loop (see its docstrings for
// the round-end dual-update gating and the freeze semantics); the iterate
// sequence matches the JAX solver up to f64-vs-f32 arithmetic and is
// cross-checked by tests/test_native_ilqr.py against the f64 CPU solver.
//
// Plain C ABI; bound via ctypes in native/qp.py. No dependencies.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

enum ConeCode { CONE_ZERO = 0, CONE_NONPOS = 1, CONE_SOC = 2 };

inline double dmax(double a, double b) { return a > b ? a : b; }

// y = M x (+ acc), M row-major [r, c]
inline void gemv(const double* M, const double* x, double* y, int r, int c) {
  for (int i = 0; i < r; ++i) {
    double acc = 0.0;
    const double* row = M + (size_t)i * c;
    for (int j = 0; j < c; ++j) acc += row[j] * x[j];
    y[i] = acc;
  }
}

inline void gemv_acc(const double* M, const double* x, double* y, int r,
                     int c) {
  for (int i = 0; i < r; ++i) {
    double acc = 0.0;
    const double* row = M + (size_t)i * c;
    for (int j = 0; j < c; ++j) acc += row[j] * x[j];
    y[i] += acc;
  }
}

// y += M^T x, M row-major [r, c]
inline void gemv_t_acc(const double* M, const double* x, double* y, int r,
                       int c) {
  for (int i = 0; i < r; ++i) {
    const double xi = x[i];
    if (xi == 0.0) continue;
    const double* row = M + (size_t)i * c;
    for (int j = 0; j < c; ++j) y[j] += row[j] * xi;
  }
}

// C (+)= A^T diag(w) B: A [p, r], B [p, c], w [p] -> C [r, c]
inline void atwb_acc(const double* A, const double* w, const double* B,
                     double* C, int p, int r, int c) {
  for (int k = 0; k < p; ++k) {
    const double wk = w[k];
    if (wk == 0.0) continue;
    const double* arow = A + (size_t)k * r;
    const double* brow = B + (size_t)k * c;
    for (int i = 0; i < r; ++i) {
      const double aw = arow[i] * wk;
      if (aw == 0.0) continue;
      double* crow = C + (size_t)i * c;
      for (int j = 0; j < c; ++j) crow[j] += aw * brow[j];
    }
  }
}

// In-place lower Cholesky; false on non-positive pivot.
bool cholesky(double* K, int s) {
  for (int j = 0; j < s; ++j) {
    double diag = K[j * s + j];
    for (int k = 0; k < j; ++k) diag -= K[j * s + k] * K[j * s + k];
    if (diag <= 0.0 || !std::isfinite(diag)) return false;
    const double Ljj = std::sqrt(diag);
    K[j * s + j] = Ljj;
    for (int i = j + 1; i < s; ++i) {
      double v = K[i * s + j];
      for (int k = 0; k < j; ++k) v -= K[i * s + k] * K[j * s + k];
      K[i * s + j] = v / Ljj;
    }
  }
  return true;
}

inline void chol_solve(const double* L, double* b, int s) {
  for (int i = 0; i < s; ++i) {
    double v = b[i];
    const double* row = L + (size_t)i * s;
    for (int k = 0; k < i; ++k) v -= row[k] * b[k];
    b[i] = v / row[i];
  }
  for (int i = s - 1; i >= 0; --i) {
    double v = b[i];
    for (int k = i + 1; k < s; ++k) v -= L[(size_t)k * s + i] * b[k];
    b[i] = v / L[(size_t)i * s + i];
  }
}

struct Prob {
  int N = 0, n = 0, m = 0, nblk = 0;
  std::vector<int> p;      // rows per block
  std::vector<int> cone;   // ConeCode per block
  std::vector<int> poff;   // row offset of block b in the concatenated lam
  int ptot = 0;            // total constraint rows per knot

  // problem data (copied at setup; update() refreshes values in place)
  std::vector<double> Q, q, R, r, H, c0;   // cost stacks
  std::vector<double> A, B, d;             // LTV dynamics
  std::vector<double> x0;
  std::vector<double> Cx, Cu, cb, mask;    // constraint stacks, knot-major
                                           // per block: Cx [N,p,n] etc.
  std::vector<size_t> cxo, cuo, cbo;       // per-block offsets into stacks

  // workspace
  std::vector<double> X, U, K, dff;        // iterate + gains
  std::vector<double> Xt, Ut;              // line-search candidate
  std::vector<double> lam;                 // [N, ptot] multipliers
  std::vector<double> rho;                 // [N] shared penalty schedule
  std::vector<double> cres, cres_t;        // [N, ptot] residuals (cur, cand)
  std::vector<double> ct, ct_t;            // [N, ptot] projected duals
  std::vector<double> lx, lu, lxx, luu, lux;
  std::vector<double> Vx, Vxx, VA, Quu, Qux, Qu, Qx, Qxx, tmpn, tmpm;
  std::vector<double> Jb;                  // SOC polar Jacobian buffer
};

// residual c_k = Cx x + Cu u + b for every block/knot into cr [N, ptot];
// terminal u treated as zero (control rows masked there by construction).
void eval_residuals(const Prob& P, const double* X, const double* U,
                    double* cr) {
  const int N = P.N, n = P.n, m = P.m;
  for (int b = 0; b < P.nblk; ++b) {
    const int p = P.p[b];
    for (int k = 0; k < N; ++k) {
      const double* cx = &P.Cx[P.cxo[b] + (size_t)k * p * n];
      const double* cu = &P.Cu[P.cuo[b] + (size_t)k * p * m];
      const double* bb = &P.cb[P.cbo[b] + (size_t)k * p];
      double* out = cr + (size_t)k * P.ptot + P.poff[b];
      std::memcpy(out, bb, sizeof(double) * p);
      gemv_acc(cx, X + (size_t)k * n, out, p, n);
      if (k < N - 1) gemv_acc(cu, U + (size_t)k * m, out, p, m);
    }
  }
}

// proj_polar per cone (z length p). ZERO: z; NONPOS: max(z,0);
// SOC: z - proj_soc(z).
inline void proj_polar(int cone, const double* z, double* out, int p) {
  if (cone == CONE_ZERO) {
    std::memcpy(out, z, sizeof(double) * p);
    return;
  }
  if (cone == CONE_NONPOS) {
    for (int i = 0; i < p; ++i) out[i] = dmax(z[i], 0.0);
    return;
  }
  double a = 0.0;
  for (int i = 0; i < p - 1; ++i) a += z[i] * z[i];
  a = std::sqrt(a);
  const double s = z[p - 1];
  if (a <= s) {  // inside K -> polar part 0
    for (int i = 0; i < p; ++i) out[i] = 0.0;
    return;
  }
  if (a <= -s) {  // inside polar -> z
    std::memcpy(out, z, sizeof(double) * p);
    return;
  }
  const double gamma = (a - s) / (2.0 * dmax(a, 1e-300));
  for (int i = 0; i < p - 1; ++i) out[i] = gamma * z[i];
  out[p - 1] = -gamma * a;
}

// violation inf-norm contribution: |c - proj_K(c)| per row.
inline double cone_violation_inf(int cone, const double* c, int p) {
  double v = 0.0;
  if (cone == CONE_ZERO) {
    for (int i = 0; i < p; ++i) v = dmax(v, std::fabs(c[i]));
    return v;
  }
  if (cone == CONE_NONPOS) {
    for (int i = 0; i < p; ++i) v = dmax(v, dmax(c[i], 0.0));
    return v;
  }
  // SOC: c - proj_soc(c)
  double a = 0.0;
  for (int i = 0; i < p - 1; ++i) a += c[i] * c[i];
  a = std::sqrt(a);
  const double s = c[p - 1];
  if (a <= s) return 0.0;
  if (a <= -s) {
    for (int i = 0; i < p; ++i) v = dmax(v, std::fabs(c[i]));
    return v;
  }
  const double gamma = (a - s) / (2.0 * dmax(a, 1e-300));
  for (int i = 0; i < p - 1; ++i) v = dmax(v, std::fabs(gamma * c[i]));
  return dmax(v, std::fabs(gamma * a));
}

// AL cost from residuals: J_pen = sum_k mask * (||ct||^2 - ||lam||^2)/(2rho),
// with ct = proj_polar(lam + rho c) also stored (per knot x row).
double al_penalty(const Prob& P, const double* cr, double* ct_out) {
  const int N = P.N;
  double J = 0.0;
  std::vector<double> z(P.ptot);
  for (int k = 0; k < N; ++k) {
    const double rho = P.rho[k];
    for (int b = 0; b < P.nblk; ++b) {
      const int p = P.p[b];
      const double mk = P.mask[(size_t)b * N + k];
      const double* lam = &P.lam[(size_t)k * P.ptot + P.poff[b]];
      const double* cb = cr + (size_t)k * P.ptot + P.poff[b];
      double* ct = ct_out + (size_t)k * P.ptot + P.poff[b];
      for (int i = 0; i < p; ++i) z[i] = lam[i] + rho * cb[i];
      proj_polar(P.cone[b], z.data(), ct, p);
      if (mk > 0.0) {
        double s_ct = 0.0, s_l = 0.0;
        for (int i = 0; i < p; ++i) {
          s_ct += ct[i] * ct[i];
          s_l += lam[i] * lam[i];
        }
        J += (s_ct - s_l) / (2.0 * rho);
      }
    }
  }
  return J;
}

// quadratic trajectory cost
double quad_cost(const Prob& P, const double* X, const double* U) {
  const int N = P.N, n = P.n, m = P.m;
  double J = 0.0;
  std::vector<double> t(dmax(n, m) + 1);
  for (int k = 0; k < N; ++k) {
    const double* x = X + (size_t)k * n;
    gemv(&P.Q[(size_t)k * n * n], x, t.data(), n, n);
    double s = 0.0;
    for (int i = 0; i < n; ++i) s += 0.5 * x[i] * t[i] + P.q[(size_t)k * n + i] * x[i];
    if (k < N - 1) {
      const double* u = U + (size_t)k * m;
      gemv(&P.R[(size_t)k * m * m], u, t.data(), m, m);
      for (int i = 0; i < m; ++i) s += 0.5 * u[i] * t[i] + P.r[(size_t)k * m + i] * u[i];
      gemv(&P.H[(size_t)k * m * n], x, t.data(), m, n);
      for (int i = 0; i < m; ++i) s += u[i] * t[i];
    }
    J += s + P.c0[k];
  }
  return J;
}

// AL expansion at (X, U) into P.lx/lu/lxx/luu/lux (also fills cres/ct for
// the current trajectory — callers reuse them for the alpha=0 cost).
void al_expansion(Prob& P, const double* X, const double* U) {
  const int N = P.N, n = P.n, m = P.m;
  std::vector<double> z(P.ptot), g(P.ptot), w(P.ptot);
  for (int k = 0; k < N; ++k) {
    const double* x = X + (size_t)k * n;
    double* lx = &P.lx[(size_t)k * n];
    double* lxx = &P.lxx[(size_t)k * n * n];
    gemv(&P.Q[(size_t)k * n * n], x, lx, n, n);
    for (int i = 0; i < n; ++i) lx[i] += P.q[(size_t)k * n + i];
    std::memcpy(lxx, &P.Q[(size_t)k * n * n], sizeof(double) * n * n);
    double* lu = &P.lu[(size_t)k * m];
    double* luu = &P.luu[(size_t)k * m * m];
    double* lux = &P.lux[(size_t)k * m * n];
    if (k < N - 1) {
      const double* u = U + (size_t)k * m;
      gemv(&P.R[(size_t)k * m * m], u, lu, m, m);
      gemv_acc(&P.H[(size_t)k * m * n], x, lu, m, n);
      for (int i = 0; i < m; ++i) lu[i] += P.r[(size_t)k * m + i];
      std::memcpy(luu, &P.R[(size_t)k * m * m], sizeof(double) * m * m);
      std::memcpy(lux, &P.H[(size_t)k * m * n], sizeof(double) * m * n);
      // lx += H' u
      gemv_t_acc(&P.H[(size_t)k * m * n], u, lx, m, n);
    } else {
      std::memset(lu, 0, sizeof(double) * m);
      std::memset(luu, 0, sizeof(double) * m * m);
      std::memset(lux, 0, sizeof(double) * m * n);
    }

    const double rho = P.rho[k];
    for (int b = 0; b < P.nblk; ++b) {
      const int p = P.p[b];
      const double mk = P.mask[(size_t)b * N + k];
      if (mk <= 0.0) continue;
      const double* cx = &P.Cx[P.cxo[b] + (size_t)k * p * n];
      const double* cu = &P.Cu[P.cuo[b] + (size_t)k * p * m];
      const double* cb = &P.cres[(size_t)k * P.ptot + P.poff[b]];
      const double* lam = &P.lam[(size_t)k * P.ptot + P.poff[b]];
      for (int i = 0; i < p; ++i) z[i] = lam[i] + rho * cb[i];
      proj_polar(P.cone[b], z.data(), g.data(), p);

      // gradient: C' g
      gemv_t_acc(cx, g.data(), lx, p, n);
      if (k < N - 1) gemv_t_acc(cu, g.data(), lu, p, m);

      // Gauss-Newton curvature rho * Jpolar
      if (P.cone[b] == CONE_ZERO) {
        for (int i = 0; i < p; ++i) w[i] = rho;
        atwb_acc(cx, w.data(), cx, lxx, p, n, n);
        if (k < N - 1) {
          atwb_acc(cu, w.data(), cu, luu, p, m, m);
          atwb_acc(cu, w.data(), cx, lux, p, m, n);
        }
      } else if (P.cone[b] == CONE_NONPOS) {
        for (int i = 0; i < p; ++i) w[i] = z[i] > 0.0 ? rho : 0.0;
        atwb_acc(cx, w.data(), cx, lxx, p, n, n);
        if (k < N - 1) {
          atwb_acc(cu, w.data(), cu, luu, p, m, m);
          atwb_acc(cu, w.data(), cx, lux, p, m, n);
        }
      } else {
        // SOC: dense rho * J_polar (small p). Closed-form boundary blocks
        // (cones.project_polar_jacobian): J_polar = I - J_soc.
        double* Jp = P.Jb.data();
        double a = 0.0;
        for (int i = 0; i < p - 1; ++i) a += z[i] * z[i];
        a = std::sqrt(a);
        const double s = z[p - 1];
        if (a <= s) {
          continue;  // inside K: J_polar = 0
        } else if (a <= -s) {
          std::memset(Jp, 0, sizeof(double) * p * p);
          for (int i = 0; i < p; ++i) Jp[i * p + i] = rho;
        } else {
          const double as = dmax(a, 1e-300);
          const double coef = (a + s) / (2.0 * as);   // J_soc vv coefficient
          const double sw = s / (2.0 * as);
          for (int i = 0; i < p - 1; ++i) {
            const double wi = z[i] / as;
            for (int j = 0; j < p - 1; ++j) {
              const double wj = z[j] / as;
              // J_polar = I - [coef I - sw w w'] on the v block
              double v = (i == j ? 1.0 - coef : 0.0) + sw * wi * wj;
              Jp[i * p + j] = rho * v;
            }
            Jp[i * p + (p - 1)] = rho * (-z[i] / as / 2.0);
            Jp[(p - 1) * p + i] = rho * (-z[i] / as / 2.0);
          }
          Jp[(p - 1) * p + (p - 1)] = rho * 0.5;
        }
        // contract C' Jp C via T = Jp C (p x n / p x m), then C' T
        std::vector<double> Tx((size_t)p * n), Tu((size_t)p * m);
        for (int i = 0; i < p; ++i) {
          double* tr = Tx.data() + (size_t)i * n;
          std::memset(tr, 0, sizeof(double) * n);
          for (int t2 = 0; t2 < p; ++t2) {
            const double jv = Jp[(size_t)i * p + t2];
            if (jv == 0.0) continue;
            const double* crow = cx + (size_t)t2 * n;
            for (int j = 0; j < n; ++j) tr[j] += jv * crow[j];
          }
        }
        for (int i = 0; i < p; ++i) {
          double* tr = Tu.data() + (size_t)i * m;
          std::memset(tr, 0, sizeof(double) * m);
          for (int t2 = 0; t2 < p; ++t2) {
            const double jv = Jp[(size_t)i * p + t2];
            if (jv == 0.0) continue;
            const double* crow = cu + (size_t)t2 * m;
            for (int j = 0; j < m; ++j) tr[j] += jv * crow[j];
          }
        }
        // lxx += Cx' Tx, luu += Cu' Tu, lux += Cu' Tx
        for (int t2 = 0; t2 < p; ++t2) {
          const double* cxr = cx + (size_t)t2 * n;
          const double* txr = Tx.data() + (size_t)t2 * n;
          for (int i = 0; i < n; ++i) {
            const double cv = cxr[i];
            if (cv == 0.0) continue;
            double* lr = lxx + (size_t)i * n;
            for (int j = 0; j < n; ++j) lr[j] += cv * txr[j];
          }
          if (k < N - 1) {
            const double* cur = cu + (size_t)t2 * m;
            const double* tur = Tu.data() + (size_t)t2 * m;
            for (int i = 0; i < m; ++i) {
              const double cv = cur[i];
              if (cv == 0.0) continue;
              double* lr = luu + (size_t)i * m;
              for (int j = 0; j < m; ++j) lr[j] += cv * tur[j];
              double* lr2 = lux + (size_t)i * n;
              for (int j = 0; j < n; ++j) lr2[j] += cv * txr[j];
            }
          }
        }
      }
    }
  }
}

// backward Riccati with regularization; fills K, dff; returns (dV1, dV2)
// through pointers; false if a Cholesky fails (treated as reject upstream
// by inflating reg — parity with the JAX solver's NaN-poisoned ls).
bool backward(Prob& P, double reg, double* dV1, double* dV2) {
  const int N = P.N, n = P.n, m = P.m;
  std::memcpy(P.Vx.data(), &P.lx[(size_t)(N - 1) * n], sizeof(double) * n);
  std::memcpy(P.Vxx.data(), &P.lxx[(size_t)(N - 1) * n * n],
              sizeof(double) * n * n);
  *dV1 = 0.0;
  *dV2 = 0.0;
  double* VA = P.VA.data();       // [n, n]
  double* Quu = P.Quu.data();     // [m, m]
  double* Qux = P.Qux.data();     // [m, n]
  double* Qu = P.Qu.data();       // [m]
  double* Qx = P.Qx.data();       // [n]
  double* Qxx = P.Qxx.data();     // [n, n]
  for (int k = N - 2; k >= 0; --k) {
    const double* A = &P.A[(size_t)k * n * n];
    const double* B = &P.B[(size_t)k * n * m];
    // VA = Vxx A, VB implicit: (Vxx B) computed as needed
    for (int i = 0; i < n; ++i) {
      const double* vr = &P.Vxx[(size_t)i * n];
      for (int j = 0; j < n; ++j) {
        double acc = 0.0;
        for (int t = 0; t < n; ++t) acc += vr[t] * A[(size_t)t * n + j];
        VA[(size_t)i * n + j] = acc;
      }
    }
    // Qx = lx + A' Vx ; Qu = lu + B' Vx
    std::memcpy(Qx, &P.lx[(size_t)k * n], sizeof(double) * n);
    gemv_t_acc(A, P.Vx.data(), Qx, n, n);
    std::memcpy(Qu, &P.lu[(size_t)k * m], sizeof(double) * m);
    gemv_t_acc(B, P.Vx.data(), Qu, n, m);
    // Qxx = lxx + A' VA
    std::memcpy(Qxx, &P.lxx[(size_t)k * n * n], sizeof(double) * n * n);
    for (int t = 0; t < n; ++t) {
      const double* ar = A + (size_t)t * n;  // row t of A = column entries
      const double* var = VA + (size_t)t * n;
      for (int i = 0; i < n; ++i) {
        const double av = ar[i];
        if (av == 0.0) continue;
        double* qr = Qxx + (size_t)i * n;
        for (int j = 0; j < n; ++j) qr[j] += av * var[j];
      }
    }
    // Qux = lux + B' VA ; Quu = luu + B' (Vxx B)
    std::memcpy(Qux, &P.lux[(size_t)k * m * n], sizeof(double) * m * n);
    std::memcpy(Quu, &P.luu[(size_t)k * m * m], sizeof(double) * m * m);
    for (int t = 0; t < n; ++t) {
      const double* br = B + (size_t)t * m;
      const double* var = VA + (size_t)t * n;
      for (int i = 0; i < m; ++i) {
        const double bv = br[i];
        if (bv == 0.0) continue;
        double* qr = Qux + (size_t)i * n;
        for (int j = 0; j < n; ++j) qr[j] += bv * var[j];
      }
    }
    // VB = Vxx B into tmp [n, m] reuse VA buffer tail? compute directly:
    // Quu += B' (Vxx B): T = Vxx B
    {
      std::vector<double>& T = P.tmpn;  // reuse, size >= n*m ensured
      for (int i = 0; i < n; ++i) {
        const double* vr = &P.Vxx[(size_t)i * n];
        double* tr = T.data() + (size_t)i * m;
        for (int j = 0; j < m; ++j) {
          double acc = 0.0;
          for (int t = 0; t < n; ++t) acc += vr[t] * B[(size_t)t * m + j];
          tr[j] = acc;
        }
      }
      for (int t = 0; t < n; ++t) {
        const double* br = B + (size_t)t * m;
        const double* tr = T.data() + (size_t)t * m;
        for (int i = 0; i < m; ++i) {
          const double bv = br[i];
          if (bv == 0.0) continue;
          double* qr = Quu + (size_t)i * m;
          for (int j = 0; j < m; ++j) qr[j] += bv * tr[j];
        }
      }
    }
    // regularized Cholesky solve for K, d
    std::vector<double>& L = P.tmpm;  // [m, m]
    std::memcpy(L.data(), Quu, sizeof(double) * m * m);
    for (int i = 0; i < m; ++i) L[(size_t)i * m + i] += reg;
    if (!cholesky(L.data(), m)) return false;
    double* Kk = &P.K[(size_t)k * m * n];
    double* dk = &P.dff[(size_t)k * m];
    for (int j = 0; j < n; ++j) {
      double col[64];
      for (int i = 0; i < m; ++i) col[i] = -Qux[(size_t)i * n + j];
      chol_solve(L.data(), col, m);
      for (int i = 0; i < m; ++i) Kk[(size_t)i * n + j] = col[i];
    }
    for (int i = 0; i < m; ++i) dk[i] = -Qu[i];
    chol_solve(L.data(), dk, m);

    // dV accumulators and value-function update
    double Quud[64];
    gemv(Quu, dk, Quud, m, m);
    for (int i = 0; i < m; ++i) {
      *dV1 += dk[i] * Qu[i];
      *dV2 += 0.5 * dk[i] * Quud[i];
    }
    // Vx = Qx + K'(Quu d + Qu) + Qux' d
    std::memcpy(P.Vx.data(), Qx, sizeof(double) * n);
    {
      double t1[64];
      for (int i = 0; i < m; ++i) t1[i] = Quud[i] + Qu[i];
      gemv_t_acc(Kk, t1, P.Vx.data(), m, n);
      gemv_t_acc(Qux, dk, P.Vx.data(), m, n);
    }
    // Vxx = Qxx + K'QuuK + K'Qux + Qux'K (symmetrized)
    {
      std::vector<double>& T = P.tmpn;  // QuuK: [m, n]
      for (int i = 0; i < m; ++i) {
        const double* qr = Quu + (size_t)i * m;
        double* tr = T.data() + (size_t)i * n;
        for (int j = 0; j < n; ++j) {
          double acc = 0.0;
          for (int t = 0; t < m; ++t) acc += qr[t] * Kk[(size_t)t * n + j];
          tr[j] = acc;
        }
      }
      std::memcpy(P.Vxx.data(), Qxx, sizeof(double) * n * n);
      for (int t = 0; t < m; ++t) {
        const double* kr = Kk + (size_t)t * n;
        const double* tr = T.data() + (size_t)t * n;
        const double* qxr = Qux + (size_t)t * n;
        for (int i = 0; i < n; ++i) {
          const double kv = kr[i];
          double* vr = &P.Vxx[(size_t)i * n];
          for (int j = 0; j < n; ++j)
            vr[j] += kv * (tr[j] + qxr[j]) + qxr[i] * kr[j];
        }
      }
      for (int i = 0; i < n; ++i)
        for (int j = i + 1; j < n; ++j) {
          const double v = 0.5 * (P.Vxx[(size_t)i * n + j] +
                                  P.Vxx[(size_t)j * n + i]);
          P.Vxx[(size_t)i * n + j] = v;
          P.Vxx[(size_t)j * n + i] = v;
        }
    }
  }
  return std::isfinite(*dV1) && std::isfinite(*dV2);
}

// closed-loop rollout at step size alpha into (Xt, Ut)
void rollout(const Prob& P, double alpha, const double* Xb, const double* Ub,
             double* Xt, double* Ut) {
  const int N = P.N, n = P.n, m = P.m;
  std::memcpy(Xt, Xb, sizeof(double) * n);  // x0
  double dx[64];
  for (int k = 0; k < N - 1; ++k) {
    const double* xb = Xb + (size_t)k * n;
    const double* x = Xt + (size_t)k * n;
    double* u = Ut + (size_t)k * m;
    for (int i = 0; i < n; ++i) dx[i] = x[i] - xb[i];
    const double* Kk = &P.K[(size_t)k * m * n];
    const double* dk = &P.dff[(size_t)k * m];
    const double* ub = Ub + (size_t)k * m;
    for (int i = 0; i < m; ++i) {
      double acc = ub[i] + alpha * dk[i];
      const double* kr = Kk + (size_t)i * n;
      for (int j = 0; j < n; ++j) acc += kr[j] * dx[j];
      u[i] = acc;
    }
    double* x1 = Xt + (size_t)(k + 1) * n;
    gemv(&P.A[(size_t)k * n * n], x, x1, n, n);
    gemv_acc(&P.B[(size_t)k * n * m], u, x1, n, m);
    const double* dd = &P.d[(size_t)k * n];
    for (int i = 0; i < n; ++i) x1[i] += dd[i];
  }
}

}  // namespace

extern "C" {

void* altro_tpu_ilqr_setup(int N, int n, int m, int nblk, const int* p_blk,
                           const int* cone_blk, const double* Q,
                           const double* q, const double* R, const double* r,
                           const double* H, const double* c0, const double* A,
                           const double* B, const double* d, const double* x0,
                           const double* Cx, const double* Cu,
                           const double* cb, const double* mask) {
  if (n > 64 || m > 64) return nullptr;  // fixed stack buffers in backward()
  Prob* P = new Prob();
  P->N = N;
  P->n = n;
  P->m = m;
  P->nblk = nblk;
  P->p.assign(p_blk, p_blk + nblk);
  P->cone.assign(cone_blk, cone_blk + nblk);
  P->poff.resize(nblk);
  int pt = 0, pmax = 1;
  size_t cxs = 0, cus = 0, cbs = 0;
  P->cxo.resize(nblk);
  P->cuo.resize(nblk);
  P->cbo.resize(nblk);
  for (int b = 0; b < nblk; ++b) {
    P->poff[b] = pt;
    P->cxo[b] = cxs;
    P->cuo[b] = cus;
    P->cbo[b] = cbs;
    pt += P->p[b];
    if (P->p[b] > pmax) pmax = P->p[b];
    cxs += (size_t)N * P->p[b] * n;
    cus += (size_t)N * P->p[b] * m;
    cbs += (size_t)N * P->p[b];
  }
  P->ptot = pt;
  P->Q.assign(Q, Q + (size_t)N * n * n);
  P->q.assign(q, q + (size_t)N * n);
  P->R.assign(R, R + (size_t)N * m * m);
  P->r.assign(r, r + (size_t)N * m);
  P->H.assign(H, H + (size_t)N * m * n);
  P->c0.assign(c0, c0 + N);
  P->A.assign(A, A + (size_t)(N - 1) * n * n);
  P->B.assign(B, B + (size_t)(N - 1) * n * m);
  P->d.assign(d, d + (size_t)(N - 1) * n);
  P->x0.assign(x0, x0 + n);
  P->Cx.assign(Cx, Cx + cxs);
  P->Cu.assign(Cu, Cu + cus);
  P->cb.assign(cb, cb + cbs);
  P->mask.assign(mask, mask + (size_t)nblk * N);

  P->X.resize((size_t)N * n);
  P->U.resize((size_t)(N - 1) * m);
  P->K.resize((size_t)(N - 1) * m * n);
  P->dff.resize((size_t)(N - 1) * m);
  P->Xt.resize((size_t)N * n);
  P->Ut.resize((size_t)(N - 1) * m);
  P->lam.assign((size_t)N * pt, 0.0);
  P->rho.assign(N, 1.0);
  P->cres.resize((size_t)N * dmax(pt, 1));
  P->cres_t.resize((size_t)N * dmax(pt, 1));
  P->ct.resize((size_t)N * dmax(pt, 1));
  P->ct_t.resize((size_t)N * dmax(pt, 1));
  P->lx.resize((size_t)N * n);
  P->lu.resize((size_t)N * m);
  P->lxx.resize((size_t)N * n * n);
  P->luu.resize((size_t)N * m * m);
  P->lux.resize((size_t)N * m * n);
  P->Vx.resize(n);
  P->Vxx.resize((size_t)n * n);
  P->VA.resize((size_t)n * n);
  P->Quu.resize((size_t)m * m);
  P->Qux.resize((size_t)m * n);
  P->Qu.resize(m);
  P->Qx.resize(n);
  P->Qxx.resize((size_t)n * n);
  P->tmpn.resize((size_t)n * dmax(n, m));
  P->tmpm.resize((size_t)m * m);
  P->Jb.resize((size_t)pmax * pmax);
  return P;
}

int altro_tpu_ilqr_update(void* h, const double* Q, const double* q,
                          const double* R, const double* r, const double* H,
                          const double* c0, const double* A, const double* B,
                          const double* d, const double* x0, const double* Cx,
                          const double* Cu, const double* cb) {
  Prob* P = static_cast<Prob*>(h);
  const int N = P->N, n = P->n, m = P->m;
  std::memcpy(P->Q.data(), Q, sizeof(double) * (size_t)N * n * n);
  std::memcpy(P->q.data(), q, sizeof(double) * (size_t)N * n);
  std::memcpy(P->R.data(), R, sizeof(double) * (size_t)N * m * m);
  std::memcpy(P->r.data(), r, sizeof(double) * (size_t)N * m);
  std::memcpy(P->H.data(), H, sizeof(double) * (size_t)N * m * n);
  std::memcpy(P->c0.data(), c0, sizeof(double) * N);
  std::memcpy(P->A.data(), A, sizeof(double) * (size_t)(N - 1) * n * n);
  std::memcpy(P->B.data(), B, sizeof(double) * (size_t)(N - 1) * n * m);
  std::memcpy(P->d.data(), d, sizeof(double) * (size_t)(N - 1) * n);
  std::memcpy(P->x0.data(), x0, sizeof(double) * n);
  std::memcpy(P->Cx.data(), Cx, sizeof(double) * P->Cx.size());
  std::memcpy(P->Cu.data(), Cu, sizeof(double) * P->Cu.size());
  std::memcpy(P->cb.data(), cb, sizeof(double) * P->cb.size());
  return 0;
}

// opts_d layout: [cost_tol, grad_tol, con_tol, pen_init, pen_scale, pen_max,
//                 reg_init, reg_min, reg_max, reg_inc, reg_dec, ls_decrease,
//                 ls_min_ratio, early_exact_tol]
// opts_i layout: [iters_outer, iters_inner, iters_ls, reset_duals,
//                 reset_penalties]
// U0/lam0/X0 nullable. lam layout: [N, ptot] concatenated blocks.
int altro_tpu_ilqr_solve(void* h, const double* opts_d, const int* opts_i,
                         const double* U0, const double* lam0,
                         const double* X0, double* X_out, double* U_out,
                         double* lam_out, int* iters_out, int* rounds_out,
                         double* viol_out, double* grad_out) {
  Prob& P = *static_cast<Prob*>(h);
  const int N = P.N, n = P.n, m = P.m;
  const double cost_tol = opts_d[0], grad_tol = opts_d[1],
               con_tol = opts_d[2], pen_init = opts_d[3],
               pen_scale = opts_d[4], pen_max = opts_d[5],
               reg_init = opts_d[6], reg_min = opts_d[7],
               reg_max = opts_d[8], reg_inc = opts_d[9],
               reg_dec = opts_d[10], ls_dec = opts_d[11],
               ls_min_ratio = opts_d[12], eet = opts_d[13];
  const int it_outer = opts_i[0], it_inner = opts_i[1], it_ls = opts_i[2];
  const bool reset_duals = opts_i[3] != 0, reset_pen = opts_i[4] != 0;

  // warm start
  if (U0)
    std::memcpy(P.U.data(), U0, sizeof(double) * (size_t)(N - 1) * m);
  else
    std::memset(P.U.data(), 0, sizeof(double) * (size_t)(N - 1) * m);
  if (lam0 && !reset_duals)
    std::memcpy(P.lam.data(), lam0, sizeof(double) * P.lam.size());
  else if (!lam0)
    std::memset(P.lam.data(), 0, sizeof(double) * P.lam.size());
  else if (reset_duals)
    std::memset(P.lam.data(), 0, sizeof(double) * P.lam.size());
  if (!lam0 || reset_pen)
    for (int k = 0; k < N; ++k) P.rho[k] = pen_init;
  if (X0) {
    std::memcpy(P.X.data(), X0, sizeof(double) * (size_t)N * n);
    std::memcpy(P.X.data(), P.x0.data(), sizeof(double) * n);
  } else {
    // open-loop init rollout (K = 0, d = 0, alpha arbitrary)
    std::memset(P.K.data(), 0, sizeof(double) * P.K.size());
    std::memset(P.dff.data(), 0, sizeof(double) * P.dff.size());
    std::vector<double> Xb((size_t)N * n, 0.0);
    std::memcpy(Xb.data(), P.x0.data(), sizeof(double) * n);
    rollout(P, 0.0, Xb.data(), P.U.data(), P.X.data(), P.U.data());
  }

  double reg = reg_init, grad = 1e30, viol = 1e30;
  int it = 0, it_rd = 0, rounds = 0;
  bool done = false;

  eval_residuals(P, P.X.data(), P.U.data(), P.cres.data());

  while (!done && rounds < it_outer) {
    al_expansion(P, P.X.data(), P.U.data());
    double dV1, dV2;
    const bool bp_ok = backward(P, reg, &dV1, &dV2);

    double grad_new = 0.0;
    if (bp_ok) {
      for (int k = 0; k < N - 1; ++k) {
        double dmaxk = 0.0, umaxk = 0.0;
        for (int i = 0; i < m; ++i) {
          dmaxk = dmax(dmaxk, std::fabs(P.dff[(size_t)k * m + i]));
          umaxk = dmax(umaxk, std::fabs(P.U[(size_t)k * m + i]));
        }
        grad_new = dmax(grad_new, dmaxk / (umaxk + 1.0));
      }
    } else {
      grad_new = 1e30;  // failed backward: force reject via empty ladder
    }
    const bool pre_done = grad_new < grad_tol;

    // alpha = 0 cost (the JAX trailing rung: equals the current AL cost for
    // a dynamically consistent X, which holds after the init rollout)
    const double J0 =
        quad_cost(P, P.X.data(), P.U.data()) + al_penalty(P, P.cres.data(),
                                                          P.ct.data());

    // backtracking ladder, first acceptable alpha = largest
    bool accepted = false, exact_full = false;
    double Jn = J0;
    if (bp_ok) {
      double alpha = 1.0;
      for (int ls = 0; ls < it_ls; ++ls, alpha *= ls_dec) {
        rollout(P, alpha, P.X.data(), P.U.data(), P.Xt.data(), P.Ut.data());
        eval_residuals(P, P.Xt.data(), P.Ut.data(), P.cres_t.data());
        const double Jt = quad_cost(P, P.Xt.data(), P.Ut.data()) +
                          al_penalty(P, P.cres_t.data(), P.ct_t.data());
        if (!std::isfinite(Jt)) continue;
        const double expected = -(alpha * dV1 + alpha * alpha * dV2);
        bool ok;
        double ratio = 0.0;
        if (expected > 1e-12) {
          ratio = (J0 - Jt) / expected;
          ok = ratio > ls_min_ratio;
        } else {
          ok = Jt < J0;
        }
        if (ok) {
          accepted = true;
          Jn = Jt;
          exact_full = (ls == 0 && eet > 0.0 && expected > 1e-12 &&
                        std::fabs(ratio - 1.0) <= eet);
          std::swap(P.X, P.Xt);
          std::swap(P.U, P.Ut);
          std::swap(P.cres, P.cres_t);
          std::swap(P.ct, P.ct_t);
          break;
        }
      }
    }

    // regularization schedule
    const bool stuck = !accepted && reg >= reg_max;
    if (accepted) {
      reg = reg * reg_dec < reg_min ? 0.0 : reg * reg_dec;
    } else {
      reg = dmax(reg, reg_min) * reg_inc;
      if (reg > reg_max) reg = reg_max;
      if (reg < reg_min) reg = reg_min;
    }
    grad = grad_new;
    ++it;
    ++it_rd;

    const double dJ = J0 - Jn;
    const bool inner_done =
        pre_done || (accepted && dJ < cost_tol) || stuck || exact_full;
    const bool round_end = inner_done || it_rd >= it_inner;

    if (round_end) {
      // violation from the adopted trajectory's residuals
      double viol_r = 0.0;
      for (int k = 0; k < N; ++k)
        for (int b = 0; b < P.nblk; ++b) {
          if (P.mask[(size_t)b * N + k] <= 0.0) continue;
          viol_r = dmax(viol_r, cone_violation_inf(
                                    P.cone[b],
                                    &P.cres[(size_t)k * P.ptot + P.poff[b]],
                                    P.p[b]));
        }
      const bool converged = viol_r < con_tol;
      const bool lam_ok = accepted || pre_done;
      for (int k = 0; k < N; ++k) {
        const double rho_k = P.rho[k];
        for (int b = 0; b < P.nblk; ++b) {
          const double mk = P.mask[(size_t)b * N + k];
          double* lam = &P.lam[(size_t)k * P.ptot + P.poff[b]];
          const double* ct = &P.ct[(size_t)k * P.ptot + P.poff[b]];
          if (lam_ok)
            for (int i = 0; i < P.p[b]; ++i) lam[i] = ct[i] * mk;
        }
        if (!converged) {
          P.rho[k] = P.rho[k] * pen_scale;
          if (P.rho[k] > pen_max) P.rho[k] = pen_max;
        }
        (void)rho_k;
      }
      viol = viol_r;
      it_rd = 0;
      ++rounds;
      done = converged;
      if (!done) {
        // penalties changed: the cached ct (projected duals) are stale for
        // the next round's alpha=0 cost, but al_expansion recomputes
        // z/projection from cres each iteration, so only cres must be
        // current — it is (adopted trajectory's residuals).
      }
    }
  }

  std::memcpy(X_out, P.X.data(), sizeof(double) * (size_t)N * n);
  std::memcpy(U_out, P.U.data(), sizeof(double) * (size_t)(N - 1) * m);
  if (lam_out)
    std::memcpy(lam_out, P.lam.data(), sizeof(double) * P.lam.size());
  *iters_out = it;
  *rounds_out = rounds;
  *viol_out = viol;
  *grad_out = grad;
  return done ? 1 : 0;
}

void altro_tpu_ilqr_free(void* h) { delete static_cast<Prob*>(h); }

}  // extern "C"
