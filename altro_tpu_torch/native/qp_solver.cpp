// Dense ADMM QP solver — native CPU oracle.
//
// Plays the role OSQP's C implementation plays in the reference
// (random_linear_problem.jl:68-76 etc.): an independent, non-JAX
// implementation of the same QP class used by the test suite to cross-check
// the JAX solvers against a foreign codebase. Same algorithm family as
// OSQP / altro_tpu.solver.admm_qp: Ruiz equilibration, splitting iteration
// with per-row penalty (equality rows get rho * 1e3), adaptive rho with
// refactorization, unscaled-residual termination.
//
// minimize 0.5 x'Px + q'x   subject to   l <= Ax <= u
//
// C ABI (ctypes-friendly); all matrices row-major double.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

using std::size_t;

struct Dense {
  int rows = 0, cols = 0;
  std::vector<double> a;
  Dense() = default;
  Dense(int r, int c) : rows(r), cols(c), a((size_t)r * c, 0.0) {}
  double& at(int i, int j) { return a[(size_t)i * cols + j]; }
  double at(int i, int j) const { return a[(size_t)i * cols + j]; }
};

// y = M x
void matvec(const Dense& M, const double* x, double* y) {
  for (int i = 0; i < M.rows; ++i) {
    double s = 0.0;
    const double* row = &M.a[(size_t)i * M.cols];
    for (int j = 0; j < M.cols; ++j) s += row[j] * x[j];
    y[i] = s;
  }
}

// y = M' x
void matvec_t(const Dense& M, const double* x, double* y) {
  for (int j = 0; j < M.cols; ++j) y[j] = 0.0;
  for (int i = 0; i < M.rows; ++i) {
    const double* row = &M.a[(size_t)i * M.cols];
    for (int j = 0; j < M.cols; ++j) y[j] += row[j] * x[i];
  }
}

// In-place lower-triangular Cholesky; returns false if not SPD.
bool cholesky(Dense& K) {
  const int n = K.rows;
  for (int j = 0; j < n; ++j) {
    double d = K.at(j, j);
    for (int k = 0; k < j; ++k) d -= K.at(j, k) * K.at(j, k);
    if (d <= 0.0) return false;
    d = std::sqrt(d);
    K.at(j, j) = d;
    for (int i = j + 1; i < n; ++i) {
      double s = K.at(i, j);
      for (int k = 0; k < j; ++k) s -= K.at(i, k) * K.at(j, k);
      K.at(i, j) = s / d;
    }
  }
  return true;
}

// Solve L L' x = b with the factor stored in the lower triangle.
void chol_solve(const Dense& L, const double* b, double* x) {
  const int n = L.rows;
  std::vector<double> t(n);
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L.at(i, k) * t[k];
    t[i] = s / L.at(i, i);
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = t[i];
    for (int k = i + 1; k < n; ++k) s -= L.at(k, i) * x[k];
    x[i] = s / L.at(i, i);
  }
}

double inf_norm(const double* x, int n) {
  double m = 0.0;
  for (int i = 0; i < n; ++i) m = std::max(m, std::fabs(x[i]));
  return m;
}

constexpr double kRhoEqScale = 1e3;
constexpr double kSigma = 1e-6;
constexpr double kAlpha = 1.6;
constexpr int kChunk = 25;

}  // namespace

extern "C" int altro_tpu_qp_solve(
    int nn, int mm, const double* P_in, const double* q_in,
    const double* A_in, const double* l_in, const double* u_in,
    double eps_abs, int max_iter, double* x_out, double* y_out,
    int* iters_out, double* rprim_out, double* rdual_out) {
  Dense P(nn, nn), A(mm, nn);
  std::memcpy(P.a.data(), P_in, sizeof(double) * nn * nn);
  std::memcpy(A.a.data(), A_in, sizeof(double) * mm * nn);
  std::vector<double> q(q_in, q_in + nn), l(l_in, l_in + mm),
      u(u_in, u_in + mm);

  // ---- Ruiz equilibration -------------------------------------------------
  std::vector<double> D(nn, 1.0), E(mm, 1.0);
  double c = 1.0;
  for (int it = 0; it < 10; ++it) {
    // column norms of [c*DPD; EAD], row norms of EAD
    std::vector<double> coln(nn, 0.0), rown(mm, 0.0);
    for (int i = 0; i < nn; ++i)
      for (int j = 0; j < nn; ++j)
        coln[j] = std::max(coln[j],
                           std::fabs(c * D[i] * P.at(i, j) * D[j]));
    for (int i = 0; i < mm; ++i)
      for (int j = 0; j < nn; ++j) {
        double v = std::fabs(E[i] * A.at(i, j) * D[j]);
        coln[j] = std::max(coln[j], v);
        rown[i] = std::max(rown[i], v);
      }
    // leave identically-zero rows/cols alone (masked constraint rows):
    // repeatedly "normalizing" them blows the scaling up geometrically.
    for (int j = 0; j < nn; ++j)
      if (coln[j] > 1e-12)
        D[j] /= std::sqrt(std::min(std::max(coln[j], 1e-8), 1e8));
    for (int i = 0; i < mm; ++i)
      if (rown[i] > 1e-12)
        E[i] /= std::sqrt(std::min(std::max(rown[i], 1e-8), 1e8));
    double pmean = 0.0, qmax = 0.0;
    for (int j = 0; j < nn; ++j) {
      double cm = 0.0;
      for (int i = 0; i < nn; ++i)
        cm = std::max(cm, std::fabs(c * D[i] * P.at(i, j) * D[j]));
      pmean += cm;
      qmax = std::max(qmax, std::fabs(c * D[j] * q[j]));
    }
    pmean /= nn;
    c /= std::min(std::max(std::max(pmean, qmax), 1e-8), 1e8);
  }

  // scaled data
  Dense Ps(nn, nn), As(mm, nn);
  std::vector<double> qs(nn), ls(mm), us(mm);
  for (int i = 0; i < nn; ++i)
    for (int j = 0; j < nn; ++j)
      Ps.at(i, j) = c * D[i] * P.at(i, j) * D[j];
  for (int i = 0; i < mm; ++i)
    for (int j = 0; j < nn; ++j) As.at(i, j) = E[i] * A.at(i, j) * D[j];
  for (int j = 0; j < nn; ++j) qs[j] = c * D[j] * q[j];
  for (int i = 0; i < mm; ++i) { ls[i] = E[i] * l[i]; us[i] = E[i] * u[i]; }

  std::vector<bool> eq(mm);
  for (int i = 0; i < mm; ++i) eq[i] = std::fabs(u[i] - l[i]) < 1e-12;

  double rho = 0.1;
  std::vector<double> rho_vec(mm);
  auto set_rho = [&](double r) {
    for (int i = 0; i < mm; ++i) rho_vec[i] = eq[i] ? r * kRhoEqScale : r;
  };
  Dense L;
  auto factor = [&]() {
    Dense K(nn, nn);
    K.a = Ps.a;
    for (int j = 0; j < nn; ++j) K.at(j, j) += kSigma;
    for (int i = 0; i < mm; ++i)
      for (int j = 0; j < nn; ++j)
        for (int k = 0; k < nn; ++k)
          K.at(j, k) += As.at(i, j) * rho_vec[i] * As.at(i, k);
    L = K;
    return cholesky(L);
  };
  set_rho(rho);
  if (!factor()) return -1;

  std::vector<double> x(nn, 0.0), z(mm), y(mm, 0.0);
  matvec(As, x.data(), z.data());
  for (int i = 0; i < mm; ++i) z[i] = std::min(std::max(z[i], ls[i]), us[i]);

  std::vector<double> rhs(nn), xt(nn), Axt(mm), tmp_n(nn), tmp_m(mm);
  double rp = 1e30, rd = 1e30;
  int it = 0;
  for (; it < max_iter;) {
    for (int k = 0; k < kChunk && it < max_iter; ++k, ++it) {
      // rhs = sigma x - qs + As'(rho z - y)
      for (int i = 0; i < mm; ++i) tmp_m[i] = rho_vec[i] * z[i] - y[i];
      matvec_t(As, tmp_m.data(), rhs.data());
      for (int j = 0; j < nn; ++j) rhs[j] += kSigma * x[j] - qs[j];
      chol_solve(L, rhs.data(), xt.data());
      matvec(As, xt.data(), Axt.data());
      for (int j = 0; j < nn; ++j)
        x[j] = kAlpha * xt[j] + (1 - kAlpha) * x[j];
      for (int i = 0; i < mm; ++i) {
        double zh = kAlpha * Axt[i] + (1 - kAlpha) * z[i];
        double zn = std::min(std::max(zh + y[i] / rho_vec[i], ls[i]), us[i]);
        y[i] += rho_vec[i] * (zh - zn);
        z[i] = zn;
      }
    }
    // unscaled residuals
    std::vector<double> xu(nn), zu(mm), yu(mm);
    for (int j = 0; j < nn; ++j) xu[j] = D[j] * x[j];
    for (int i = 0; i < mm; ++i) {
      zu[i] = z[i] / E[i];
      yu[i] = (E[i] / c) * y[i];
    }
    matvec(A, xu.data(), tmp_m.data());
    for (int i = 0; i < mm; ++i) tmp_m[i] -= zu[i];
    rp = inf_norm(tmp_m.data(), mm);
    matvec(P, xu.data(), tmp_n.data());
    matvec_t(A, yu.data(), rhs.data());
    for (int j = 0; j < nn; ++j) tmp_n[j] += q[j] + rhs[j];
    rd = inf_norm(tmp_n.data(), nn);
    if (rp < eps_abs && rd < eps_abs) break;

    // adaptive rho on relative scaled residuals
    matvec(As, x.data(), tmp_m.data());
    double ax = inf_norm(tmp_m.data(), mm), zn = inf_norm(z.data(), mm);
    for (int i = 0; i < mm; ++i) tmp_m[i] -= z[i];
    double rps = inf_norm(tmp_m.data(), mm) / std::max(std::max(ax, zn), 1e-10);
    matvec(Ps, x.data(), tmp_n.data());
    double px = inf_norm(tmp_n.data(), nn);
    matvec_t(As, y.data(), rhs.data());
    double aty = inf_norm(rhs.data(), nn), qn = inf_norm(qs.data(), nn);
    for (int j = 0; j < nn; ++j) tmp_n[j] += qs[j] + rhs[j];
    double rds = inf_norm(tmp_n.data(), nn) /
                 std::max(std::max(px, std::max(aty, qn)), 1e-10);
    double prop = rho * std::sqrt(rps / std::max(rds, 1e-16));
    prop = std::min(std::max(prop, 1e-6), 1e6);
    if (prop > 5.0 * rho || prop < rho / 5.0) {
      rho = prop;
      set_rho(rho);
      if (!factor()) return -1;
    }
  }

  for (int j = 0; j < nn; ++j) x_out[j] = D[j] * x[j];
  for (int i = 0; i < mm; ++i) y_out[i] = (E[i] / c) * y[i];
  *iters_out = it;
  *rprim_out = rp;
  *rdual_out = rd;
  return (rp < eps_abs && rd < eps_abs) ? 0 : 1;
}

// ---------------------------------------------------------------------------
// Dense ADMM conic solver — native CPU oracle for the SOC program class.
//
// Plays the role ECOS/COSMO/Mosek play in the reference (rocket
// run_simple_rocket.jl:156-188, grasp grasp_benchmark.jl:36-62): an
// independent non-JAX cross-check for the conic path. Program form matches
// altro_tpu.transcribe.BatchConic:
//
//   minimize 0.5 x'Px + q'x   subject to   Ax + s = b,  s in K
//
// K is a product of segments seg_type[i] in {0: zero, 1: nonneg,
// 2: second-order cone (t last: ||v[:-1]|| <= v[-1])} with lengths
// seg_len[i]. The splitting variable w = Ax lives in the shifted set
// C = {w : b - w in K}; its projection is w = b - Pi_K(b - w). Ruiz row
// scaling is kept uniform inside each SOC segment (geometric mean), since
// the cone is only invariant under uniform positive scaling.
// ---------------------------------------------------------------------------

namespace {

// Project v (length p) onto the SOC {(y, t): ||y|| <= t}, t last element.
void soc_project(double* v, int p) {
  double a = 0.0;
  for (int i = 0; i < p - 1; ++i) a += v[i] * v[i];
  a = std::sqrt(a);
  double s = v[p - 1];
  if (a <= s) return;                       // inside
  if (a <= -s) {                            // inside the polar: project to 0
    for (int i = 0; i < p; ++i) v[i] = 0.0;
    return;
  }
  double scale = (a + s) / (2.0 * a);       // boundary ray (a > 0 here)
  for (int i = 0; i < p - 1; ++i) v[i] *= scale;
  v[p - 1] = scale * a;
}

}  // namespace

extern "C" int altro_tpu_conic_solve(
    int nn, int mm, int nseg, const double* P_in, const double* q_in,
    const double* A_in, const double* b_in, const int* seg_type,
    const int* seg_len, double eps_abs, int max_iter, double* x_out,
    double* y_out, int* iters_out, double* rprim_out, double* rdual_out) {
  Dense P(nn, nn), A(mm, nn);
  std::memcpy(P.a.data(), P_in, sizeof(double) * nn * nn);
  std::memcpy(A.a.data(), A_in, sizeof(double) * mm * nn);
  std::vector<double> q(q_in, q_in + nn), b(b_in, b_in + mm);

  // ---- Ruiz equilibration (SOC segments share one row scale) --------------
  std::vector<double> D(nn, 1.0), E(mm, 1.0);
  double c = 1.0;
  for (int it = 0; it < 10; ++it) {
    std::vector<double> coln(nn, 0.0), rown(mm, 0.0);
    for (int i = 0; i < nn; ++i)
      for (int j = 0; j < nn; ++j)
        coln[j] = std::max(coln[j], std::fabs(c * D[i] * P.at(i, j) * D[j]));
    for (int i = 0; i < mm; ++i)
      for (int j = 0; j < nn; ++j) {
        double v = std::fabs(E[i] * A.at(i, j) * D[j]);
        coln[j] = std::max(coln[j], v);
        rown[i] = std::max(rown[i], v);
      }
    std::vector<double> de(mm, 1.0);
    for (int i = 0; i < mm; ++i)
      if (rown[i] > 1e-12)
        de[i] = 1.0 / std::sqrt(std::min(std::max(rown[i], 1e-8), 1e8));
    // uniform scale inside each SOC segment: geometric mean of the rows
    {
      int off = 0;
      for (int s = 0; s < nseg; ++s) {
        int p = seg_len[s];
        if (seg_type[s] == 2) {
          double lg = 0.0;
          for (int i = 0; i < p; ++i) lg += std::log(de[off + i]);
          double g = std::exp(lg / p);
          for (int i = 0; i < p; ++i) de[off + i] = g;
        }
        off += p;
      }
    }
    for (int j = 0; j < nn; ++j)
      if (coln[j] > 1e-12)
        D[j] /= std::sqrt(std::min(std::max(coln[j], 1e-8), 1e8));
    for (int i = 0; i < mm; ++i) E[i] *= de[i];
    double pmean = 0.0, qmax = 0.0;
    for (int j = 0; j < nn; ++j) {
      double cm = 0.0;
      for (int i = 0; i < nn; ++i)
        cm = std::max(cm, std::fabs(c * D[i] * P.at(i, j) * D[j]));
      pmean += cm;
      qmax = std::max(qmax, std::fabs(c * D[j] * q[j]));
    }
    pmean /= nn;
    c /= std::min(std::max(std::max(pmean, qmax), 1e-8), 1e8);
  }

  // scaled data
  Dense Ps(nn, nn), As(mm, nn);
  std::vector<double> qs(nn), bs(mm);
  for (int i = 0; i < nn; ++i)
    for (int j = 0; j < nn; ++j) Ps.at(i, j) = c * D[i] * P.at(i, j) * D[j];
  for (int i = 0; i < mm; ++i)
    for (int j = 0; j < nn; ++j) As.at(i, j) = E[i] * A.at(i, j) * D[j];
  for (int j = 0; j < nn; ++j) qs[j] = c * D[j] * q[j];
  for (int i = 0; i < mm; ++i) bs[i] = E[i] * b[i];

  std::vector<bool> eq(mm, false);
  {
    int off = 0;
    for (int s = 0; s < nseg; ++s) {
      for (int i = 0; i < seg_len[s]; ++i) eq[off + i] = (seg_type[s] == 0);
      off += seg_len[s];
    }
    if (off != mm) return -2;  // segment lengths must cover all rows
  }

  // project w onto C = {w : bs - w in K} in scaled space (in place)
  auto project_C = [&](double* w) {
    int off = 0;
    std::vector<double> t;
    for (int s = 0; s < nseg; ++s) {
      int p = seg_len[s];
      if (seg_type[s] == 0) {  // zero cone: w = bs
        for (int i = 0; i < p; ++i) w[off + i] = bs[off + i];
      } else if (seg_type[s] == 1) {  // nonneg slack: w <= bs
        for (int i = 0; i < p; ++i)
          w[off + i] = std::min(w[off + i], bs[off + i]);
      } else {  // SOC
        t.assign(p, 0.0);
        for (int i = 0; i < p; ++i) t[i] = bs[off + i] - w[off + i];
        soc_project(t.data(), p);
        for (int i = 0; i < p; ++i) w[off + i] = bs[off + i] - t[i];
      }
      off += p;
    }
  };

  double rho = 0.1;
  std::vector<double> rho_vec(mm);
  auto set_rho = [&](double r) {
    for (int i = 0; i < mm; ++i) rho_vec[i] = eq[i] ? r * kRhoEqScale : r;
  };
  Dense L;
  auto factor = [&]() {
    Dense K(nn, nn);
    K.a = Ps.a;
    for (int j = 0; j < nn; ++j) K.at(j, j) += kSigma;
    for (int i = 0; i < mm; ++i)
      for (int j = 0; j < nn; ++j)
        for (int k = 0; k < nn; ++k)
          K.at(j, k) += As.at(i, j) * rho_vec[i] * As.at(i, k);
    L = K;
    return cholesky(L);
  };
  set_rho(rho);
  if (!factor()) return -1;

  std::vector<double> x(nn, 0.0), z(mm), y(mm, 0.0);
  matvec(As, x.data(), z.data());
  project_C(z.data());

  std::vector<double> rhs(nn), xt(nn), Axt(mm), tmp_n(nn), tmp_m(mm);
  double rp = 1e30, rd = 1e30;
  int it = 0;
  for (; it < max_iter;) {
    for (int k = 0; k < kChunk && it < max_iter; ++k, ++it) {
      for (int i = 0; i < mm; ++i) tmp_m[i] = rho_vec[i] * z[i] - y[i];
      matvec_t(As, tmp_m.data(), rhs.data());
      for (int j = 0; j < nn; ++j) rhs[j] += kSigma * x[j] - qs[j];
      chol_solve(L, rhs.data(), xt.data());
      matvec(As, xt.data(), Axt.data());
      for (int j = 0; j < nn; ++j)
        x[j] = kAlpha * xt[j] + (1 - kAlpha) * x[j];
      for (int i = 0; i < mm; ++i)
        tmp_m[i] = kAlpha * Axt[i] + (1 - kAlpha) * z[i];
      std::vector<double> zn(mm);
      for (int i = 0; i < mm; ++i) zn[i] = tmp_m[i] + y[i] / rho_vec[i];
      project_C(zn.data());
      for (int i = 0; i < mm; ++i) {
        y[i] += rho_vec[i] * (tmp_m[i] - zn[i]);
        z[i] = zn[i];
      }
    }
    // unscaled residuals
    std::vector<double> xu(nn), zu(mm), yu(mm);
    for (int j = 0; j < nn; ++j) xu[j] = D[j] * x[j];
    for (int i = 0; i < mm; ++i) {
      zu[i] = z[i] / E[i];
      yu[i] = (E[i] / c) * y[i];
    }
    matvec(A, xu.data(), tmp_m.data());
    for (int i = 0; i < mm; ++i) tmp_m[i] -= zu[i];
    rp = inf_norm(tmp_m.data(), mm);
    matvec(P, xu.data(), tmp_n.data());
    matvec_t(A, yu.data(), rhs.data());
    for (int j = 0; j < nn; ++j) tmp_n[j] += q[j] + rhs[j];
    rd = inf_norm(tmp_n.data(), nn);
    if (rp < eps_abs && rd < eps_abs) break;

    // adaptive rho on relative scaled residuals
    matvec(As, x.data(), tmp_m.data());
    double ax = inf_norm(tmp_m.data(), mm), znorm = inf_norm(z.data(), mm);
    for (int i = 0; i < mm; ++i) tmp_m[i] -= z[i];
    double rps =
        inf_norm(tmp_m.data(), mm) / std::max(std::max(ax, znorm), 1e-10);
    matvec(Ps, x.data(), tmp_n.data());
    double px = inf_norm(tmp_n.data(), nn);
    matvec_t(As, y.data(), rhs.data());
    double aty = inf_norm(rhs.data(), nn), qn = inf_norm(qs.data(), nn);
    for (int j = 0; j < nn; ++j) tmp_n[j] += qs[j] + rhs[j];
    double rds = inf_norm(tmp_n.data(), nn) /
                 std::max(std::max(px, std::max(aty, qn)), 1e-10);
    double prop = rho * std::sqrt(rps / std::max(rds, 1e-16));
    prop = std::min(std::max(prop, 1e-6), 1e6);
    if (prop > 5.0 * rho || prop < rho / 5.0) {
      rho = prop;
      set_rho(rho);
      if (!factor()) return -1;
    }
  }

  for (int j = 0; j < nn; ++j) x_out[j] = D[j] * x[j];
  for (int i = 0; i < mm; ++i) y_out[i] = (E[i] / c) * y[i];
  *iters_out = it;
  *rprim_out = rp;
  *rdual_out = rd;
  return (rp < eps_abs && rd < eps_abs) ? 0 : 1;
}
