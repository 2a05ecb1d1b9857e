// Square-marker PnP over a batch of detection slots, float64, on Hopper
// (sm_90a): one warp per slot.
//
// Replaces vican_tpu/ops/pnp.py:334 solve_marker_pose as
// vican_tpu/perception.py:883 _pnp_block vmaps it over a batch's B*D
// detection slots.  That block has no Pallas counterpart: XLA compiles it
// into every detect program of the JAX package.  The plain PyTorch version
// is vican_torch/ops/pnp.py:pnp_block_plain (batched torch ops on the valid
// slots, ~1e4 launches a 32-frame batch); this kernel computes the same
// function in one launch.
//
// Operands (see vican_torch/ops/pnp.py:pnp_block):
//   corners (N, 4, 2) f64, ids (N,) int64, valid (N,) bool   N = B * D
//   Ks (B, 3, 3) f64, dists (B, 14) f64 (12 modeled coefficients)
//   out (N, 23) f64: corners (8), id, ok, R (9, row-major), t (3), the
//   largest corner reprojection error in px.  A slot that is not valid
//   holds its corners and id and zeros elsewhere; a valid slot holds its
//   pose whatever it is, and ok = 1 only where R, t and the error are all
//   finite.
//
// Each slot runs the plain version's steps in its order: the 8-trip
// fixed-point undistortion, the 4-point homography (an 8x8 LU with partial
// pivoting), then either IPPE (method 0: both sign candidates, their
// normal-equation translations, the behind-camera inf) or the homography
// initialization projected onto SO(3) by the 5-sweep one-sided Jacobi SVD
// of vican_torch/ops/lie.py:_svd3_jacobi followed by its own LM (method 1),
// then the LM refinement (vican_torch/ops/pnp.py:refine_lm) and the
// reprojection error.  Branches follow the plain version's: rodrigues'
// series below theta^2 = 1e-16, so3_log's small-angle, near-pi and
// dominant-column cases, LM's accept test, lambda * 0.3 / * 3 and its clamp
// to [1e-12, 1e12], LU's first largest pivot.  Clamps propagate NaN as
// torch.clamp does (a NaN compares false), so a degenerate slot ends
// non-finite, as in the plain version.  The LM Jacobian is forward-mode,
// as jax.jacfwd and the plain version's JVPs compute it: the residual is
// written once (project), templated on its scalar, and runs on dual
// numbers.
//
// What bounds it: operations, in float64: ~7.4e4 a valid slot for IPPE
// with 20 LM trips, ~1.4e5 for the iterative method (tools/kernel_times.py's
// PNP_FLOPS tallies them); a slot that is not valid costs nothing.  P's
// first 32-frame batch holds 256 valid slots of 768: ~1.9e7 operations,
// ~0.55 us at the H100's 34 TFLOP/s; its ~0.2 MB of operands take ~0.06
// us.  No design reaches that: each slot is a dependent chain (20 LM
// trips, each a Jacobian, a 6x6 solve and a trial point, full of
// divisions, square roots and sines), and there are only a few hundred
// slots, so the kernel's time is one slot's chain.
//
// The design shortens that chain.  A block holds SLOTS warps, a warp one
// slot; a warp whose slot is not valid writes its head and zeros and
// returns.  In each LM trip lane 6k + j carries tangent j of corner k's two
// residual rows on a dual number with one tangent (2 doubles; a thread a
// slot would carry all six, 7 doubles), lanes 24-27 the corners' residuals;
// each of the 21 + 6 + 1 sums of J^T J, J^T r and r^T r is one lane's, over
// the 8 rows in the plain version's order (corner 0's u row, its v row,
// corner 1's, ...) from shuffles; every lane gathers the sums and runs the
// damped 6x6 LU itself (spreading it a row a lane would add a shuffle round
// trip to each dependent step of the elimination); the lanes then evaluate
// their rows at the trial point, whose residual lanes give the trial cost in
// corner order and, when it is accepted, the next trip's rows: one dual
// evaluation a trip.  The undistortion runs a corner a lane.  The values are
// divided; the tangents and the LUs multiply by reciprocals, which run
// beside the chain instead of on it.  Every lane runs the same code on its
// own operands (translation tangents included, whose zero rotation tangents
// a branch would skip only by serializing the warp), so nothing diverges.
#include <cuda_runtime.h>
#include <math.h>

namespace {

// ---------------------------------------------------------------------------
// A dual number with one tangent of the LM parameters (rvec, t): a lane's.

struct Dual {
  double v, d;
};

__device__ __forceinline__ double val(double a) { return a; }
__device__ __forceinline__ double val(const Dual& a) { return a.v; }

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  return {a.v + b.v, a.d + b.d};
}
__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  return {a.v - b.v, a.d - b.d};
}
__device__ __forceinline__ Dual operator-(const Dual& a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
// A quotient's tangent multiplies by the divisor's reciprocal, which runs
// beside the value's division: one division on the dependent chain.
__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  const double v = a.v / b.v;
  return {v, (a.d - v * b.d) * (1.0 / b.v)};
}
__device__ __forceinline__ Dual operator+(const Dual& a, double b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator+(double a, const Dual& b) { return b + a; }
__device__ __forceinline__ Dual operator-(const Dual& a, double b) { return {a.v - b, a.d}; }
__device__ __forceinline__ Dual operator-(double a, const Dual& b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ Dual operator*(double a, const Dual& b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator*(const Dual& a, double b) { return b * a; }
__device__ __forceinline__ Dual operator/(const Dual& a, double b) { return {a.v / b, a.d / b}; }

__device__ __forceinline__ double dsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ double dsin(double a) { return sin(a); }
__device__ __forceinline__ double dcos(double a) { return cos(a); }
// ... and a square root's tangent takes rsqrt beside sqrt
__device__ __forceinline__ Dual dsqrt(const Dual& a) {
  return {sqrt(a.v), a.d * (0.5 * rsqrt(a.v))};
}
__device__ __forceinline__ Dual dsin(const Dual& a) { return {sin(a.v), cos(a.v) * a.d}; }
__device__ __forceinline__ Dual dcos(const Dual& a) { return {cos(a.v), -sin(a.v) * a.d}; }

// torch.clamp / clamp_min: a NaN compares false and passes through
__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }
__device__ __forceinline__ double clamp(double x, double lo, double hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------------------
// The camera and the residual, written once for double and Dual.

struct Cam {
  double fx, fy, cx, cy;
  double k[12];  // k1 k2 p1 p2 k3 k4 k5 k6 s1 s2 s3 s4
};

// Rodrigues (vican_torch/ops/lie.py:rodrigues): the series forms of
// sin(t)/t and (1 - cos t)/t^2 below t^2 = 1e-16, the derivative of the
// branch taken.
template <class T>
__device__ __forceinline__ void rodrigues(const T w[3], T R[3][3]) {
  const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  T a, b;
  if (val(th2) < 1e-16) {
    a = 1.0 - th2 / 6.0;
    b = 0.5 - th2 / 24.0;
  } else {
    const T th = dsqrt(th2);
    a = dsin(th) / th;
    b = (1.0 - dcos(th)) / th2;
  }
  // K = hat(w); K K = w w^T - |w|^2 I
  R[0][0] = 1.0 + b * (-(w[2] * w[2]) - w[1] * w[1]);
  R[1][1] = 1.0 + b * (-(w[2] * w[2]) - w[0] * w[0]);
  R[2][2] = 1.0 + b * (-(w[1] * w[1]) - w[0] * w[0]);
  const T w01 = w[0] * w[1], w02 = w[0] * w[2], w12 = w[1] * w[2];
  R[0][1] = -(a * w[2]) + b * w01;
  R[1][0] = a * w[2] + b * w01;
  R[0][2] = a * w[1] + b * w02;
  R[2][0] = -(a * w[1]) + b * w02;
  R[1][2] = -(a * w[0]) + b * w12;
  R[2][1] = a * w[0] + b * w12;
}

// One marker corner (qx, qy, 0) through the pose and the 12-coefficient
// rational + thin-prism model (vican_torch/ops/pnp.py:project_points); the
// corner's z is 0, so R's third column drops out.
template <class T>
__device__ __forceinline__ void project(const T R[3][3], const T t[3], const Cam& c, double qx,
                                        double qy, T& u, T& v) {
  const T X = R[0][0] * qx + R[0][1] * qy + t[0];
  const T Y = R[1][0] * qx + R[1][1] * qy + t[1];
  const T Z = R[2][0] * qx + R[2][1] * qy + t[2];
  const T x = X / Z, y = Y / Z;
  const double k1 = c.k[0], k2 = c.k[1], p1 = c.k[2], p2 = c.k[3], k3 = c.k[4], k4 = c.k[5],
               k5 = c.k[6], k6 = c.k[7], s1 = c.k[8], s2 = c.k[9], s3 = c.k[10], s4 = c.k[11];
  const T r2 = x * x + y * y;
  const T r4 = r2 * r2;
  const T r6 = r4 * r2;
  const T radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6);
  const T xy = x * y;
  const T xd = x * radial + (2.0 * p1) * xy + p2 * (r2 + 2.0 * (x * x)) + s1 * r2 + s2 * r4;
  const T yd = y * radial + p1 * (r2 + 2.0 * (y * y)) + (2.0 * p2) * xy + s3 * r2 + s4 * r4;
  u = c.fx * xd + c.cx;
  v = c.fy * yd + c.cy;
}

// ---------------------------------------------------------------------------
// Small dense solves: LU with partial pivoting (the first largest |pivot|,
// as LAPACK's idamax), a zero pivot left unscaled as LAPACK's getrf leaves
// it, so a singular system gives inf or NaN in the back substitution.
// Every index is a compile-time constant after unrolling, so the matrix
// stays in registers: the row swap is a predicated exchange.  It multiplies
// by the pivots' reciprocals instead of dividing: the back substitution's
// reciprocals are ready before it starts, so its chain holds no division.

template <int n, int m>
__device__ __forceinline__ void lu_solve(double A[n][n], double B[n][m]) {
#pragma unroll
  for (int k = 0; k < n; ++k) {
    int piv = k;
    double amax = fabs(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < n; ++i) {
      const double a = fabs(A[i][k]);
      if (a > amax) {
        amax = a;
        piv = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < n; ++i) {
      if (piv == i) {
#pragma unroll
        for (int j = 0; j < n; ++j) {
          const double tmp = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = tmp;
        }
#pragma unroll
        for (int j = 0; j < m; ++j) {
          const double tmp = B[k][j];
          B[k][j] = B[i][j];
          B[i][j] = tmp;
        }
      }
    }
    const double p = A[k][k], rp = 1.0 / p;
    if (p != 0.0) {
#pragma unroll
      for (int i = k + 1; i < n; ++i) {
        const double l = A[i][k] * rp;
#pragma unroll
        for (int j = k + 1; j < n; ++j) A[i][j] -= l * A[k][j];
#pragma unroll
        for (int j = 0; j < m; ++j) B[i][j] -= l * B[k][j];
      }
    }
  }
#pragma unroll
  for (int k = n - 1; k >= 0; --k) {
#pragma unroll
    for (int j = 0; j < m; ++j) {
      double s = B[k][j];
#pragma unroll
      for (int i = k + 1; i < n; ++i) s -= A[k][i] * B[i][j];
      B[k][j] = s * (1.0 / A[k][k]);
    }
  }
}

// ---------------------------------------------------------------------------
// SO(3) helpers in double.

__device__ __forceinline__ double dot3(const double a[3], const double b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const double a[3], const double b[3], double out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ double det3(const double m[3][3]) {
  return m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
         m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
         m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
}

// so3_log (vican_torch/ops/lie.py:so3_log): guarded near 0 and near pi,
// where the axis is the dominant column of R + I signed like w.
__device__ __forceinline__ void so3_log(const double R[3][3], double out[3]) {
  const double tr = R[0][0] + R[1][1] + R[2][2];
  const double cos_t = clamp((tr - 1.0) * 0.5, -1.0, 1.0);
  const double th = acos(cos_t);
  const double w[3] = {R[2][1] - R[1][2], R[0][2] - R[2][0], R[1][0] - R[0][1]};
  if (cos_t < -1.0 + 1e-6) {
    double Bm[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Bm[i][j] = R[i][j] + (i == j ? 1.0 : 0.0);
    // torch.argmax: the first largest column norm, a NaN counting as largest
    double best = sqrt(Bm[0][0] * Bm[0][0] + Bm[1][0] * Bm[1][0] + Bm[2][0] * Bm[2][0]);
    int col = 0;
#pragma unroll
    for (int j = 1; j < 3; ++j) {
      const double nj = sqrt(Bm[0][j] * Bm[0][j] + Bm[1][j] * Bm[1][j] + Bm[2][j] * Bm[2][j]);
      if (!isnan(best) && (isnan(nj) || nj > best)) {
        best = nj;
        col = j;
      }
    }
    double axis[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      axis[i] = col == 0 ? Bm[i][0] : col == 1 ? Bm[i][1] : Bm[i][2];
    const double nrm = clamp_min(sqrt(dot3(axis, axis)), 1e-12);
#pragma unroll
    for (int i = 0; i < 3; ++i) axis[i] = axis[i] / nrm;
    const double sign = dot3(axis, w) < 0 ? -1.0 : 1.0;
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = axis[i] * sign * th;
  } else {
    const double sc = th < 1e-6 ? 0.5 + th * th / 12.0 : th / clamp_min(2.0 * sin(th), 1e-12);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = w[i] * sc;
  }
}

__device__ __forceinline__ double normalize3(double a[3]) {
  const double n = sqrt(dot3(a, a));
  const double inv = 1.0 / clamp_min(n, 1e-30);
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i] = a[i] * inv;
  return n;
}

// project_so3 (vican_torch/ops/lie.py:_svd3_jacobi and svd3_so3, float64
// constants): 5 cyclic one-sided Jacobi sweeps carrying V only, sigma and
// U from A V, a descending compare-swap sort, U's orthonormal completion
// and Gram-Schmidt cleanup, then R = U diag(1, 1, det(U V^T)) V^T.
__device__ __forceinline__ void project_so3(const double X[3][3], double Rout[3][3]) {
  const double tiny = 1e-30, eps2 = 1e-30, rel = 1e-12;
  double V[3][3] = {{1.0, 0.0, 0.0}, {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0}};  // V[j]: column j
#pragma unroll
  for (int sweep = 0; sweep < 5; ++sweep) {
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      double bp[3], bq[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        bp[i] = X[i][0] * V[p][0] + X[i][1] * V[p][1] + X[i][2] * V[p][2];
        bq[i] = X[i][0] * V[q][0] + X[i][1] * V[q][1] + X[i][2] * V[q][2];
      }
      const double alpha = dot3(bp, bp), beta = dot3(bq, bq), gamma = dot3(bp, bq);
      double zeta = (beta - alpha) / clamp_min(2.0 * fabs(gamma), tiny);
      if (gamma < 0) zeta = -zeta;
      double t = 1.0 / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      if (zeta < 0) t = -t;
      double c = 1.0 / sqrt(1.0 + t * t);
      double s = c * t;
      if (gamma * gamma <= eps2 * alpha * beta) {
        c = 1.0;
        s = 0.0;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const double a = V[p][i], b = V[q][i];
        V[p][i] = c * a - s * b;
        V[q][i] = s * a + c * b;
      }
    }
  }
  double B[3][3], sig[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      B[j][i] = X[i][0] * V[j][0] + X[i][1] * V[j][1] + X[i][2] * V[j][2];
    sig[j] = sqrt(dot3(B[j], B[j]));
  }
#pragma unroll
  for (int pair = 0; pair < 3; ++pair) {
    const int i = pair == 2 ? 1 : 0, j = pair == 0 ? 1 : 2;
    if (sig[i] < sig[j]) {
      double tmp = sig[i];
      sig[i] = sig[j];
      sig[j] = tmp;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        tmp = B[i][k];
        B[i][k] = B[j][k];
        B[j][k] = tmp;
        tmp = V[i][k];
        V[i][k] = V[j][k];
        V[j][k] = tmp;
      }
    }
  }
  const double ex[3] = {1.0, 0.0, 0.0}, ey[3] = {0.0, 1.0, 0.0};
  double u0[3] = {B[0][0], B[0][1], B[0][2]};
  normalize3(u0);
  if (sig[0] <= tiny) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u0[i] = ex[i];
  }
  double w0[3], w1[3];
  cross3(u0, ex, w0);
  cross3(u0, ey, w1);
  const double wn0 = normalize3(w0), wn1 = normalize3(w1);
  double u1[3] = {B[1][0], B[1][1], B[1][2]};
  normalize3(u1);
  if (sig[1] <= rel * sig[0]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u1[i] = wn0 > wn1 ? w0[i] : w1[i];
  }
  const double d01 = dot3(u0, u1);
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] = u1[i] - d01 * u0[i];
  normalize3(u1);
  double u2[3] = {B[2][0], B[2][1], B[2][2]};
  normalize3(u2);
  double fb2[3];
  cross3(u0, u1, fb2);
  normalize3(fb2);
  if (sig[2] <= rel * sig[0]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u2[i] = fb2[i];
  }
  const double d02 = dot3(u0, u2), d12 = dot3(u1, u2);
#pragma unroll
  for (int i = 0; i < 3; ++i) u2[i] = u2[i] - d02 * u0[i] - d12 * u1[i];
  normalize3(u2);
  const double U[3][3] = {{u0[0], u1[0], u2[0]}, {u0[1], u1[1], u2[1]}, {u0[2], u1[2], u2[2]}};
  const double det = det3(U) * det3(V);  // V's rows are V^T's rows: det(V^T) = det(V)
  const double fix[3] = {1.0, 1.0, det};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      Rout[i][k] = U[i][0] * fix[0] * V[0][k] + U[i][1] * fix[1] * V[1][k] +
                   U[i][2] * fix[2] * V[2][k];
}

// ---------------------------------------------------------------------------
// The steps of solve_marker_pose.

// undistort_points: 8 fixed-point trips from the distorted normalized
// coords of one corner
__device__ __forceinline__ void undistort_corner(double pu, double pv, const Cam& c, double& x,
                                                 double& y) {
  const double k1 = c.k[0], k2 = c.k[1], p1 = c.k[2], p2 = c.k[3], k3 = c.k[4], k4 = c.k[5],
               k5 = c.k[6], k6 = c.k[7], s1 = c.k[8], s2 = c.k[9], s3 = c.k[10], s4 = c.k[11];
  const double tx = (pu - c.cx) / c.fx, ty = (pv - c.cy) / c.fy;
  x = tx;
  y = ty;
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    const double r2 = x * x + y * y;
    const double r4 = r2 * r2;
    const double r6 = r4 * r2;
    const double radial =
        (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6);
    const double dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4;
    const double dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2 + s4 * r4;
    x = (tx - dx) / radial;
    y = (ty - dy) / radial;
  }
}

// homography_4pt: the DLT with H[2][2] = 1, rows (x, y, 1, 0, 0, 0, -u x,
// -u y) and (0, 0, 0, x, y, 1, -v x, -v y) per point
__device__ __forceinline__ void homography(const double q[4][2], const double xy[8],
                                           double H[3][3]) {
  double A[8][8], b[8][1];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double x = q[k][0], y = q[k][1], u = xy[2 * k], v = xy[2 * k + 1];
    const double r1[8] = {x, y, 1.0, 0.0, 0.0, 0.0, -u * x, -u * y};
    const double r2[8] = {0.0, 0.0, 0.0, x, y, 1.0, -v * x, -v * y};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      A[2 * k][j] = r1[j];
      A[2 * k + 1][j] = r2[j];
    }
    b[2 * k][0] = u;
    b[2 * k + 1][0] = v;
  }
  lu_solve<8, 1>(A, b);
  H[0][0] = b[0][0]; H[0][1] = b[1][0]; H[0][2] = b[2][0];
  H[1][0] = b[3][0]; H[1][1] = b[4][0]; H[1][2] = b[5][0];
  H[2][0] = b[6][0]; H[2][1] = b[7][0]; H[2][2] = 1.0;
}

// _translation_lsq: the normal equations of (R q + t)_x - x (R q + t)_z = 0
// (and y) over the four corners
__device__ __forceinline__ void translation_lsq(const double R[3][3], const double q[4][2],
                                                const double xy[8], double t[3]) {
  double A[8][3], b[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double x = xy[2 * k], y = xy[2 * k + 1];
    const double Rq0 = R[0][0] * q[k][0] + R[0][1] * q[k][1];
    const double Rq1 = R[1][0] * q[k][0] + R[1][1] * q[k][1];
    const double Rq2 = R[2][0] * q[k][0] + R[2][1] * q[k][1];
    A[k][0] = 1.0; A[k][1] = 0.0; A[k][2] = -x;
    A[4 + k][0] = 0.0; A[4 + k][1] = 1.0; A[4 + k][2] = -y;
    b[k] = x * Rq2 - Rq0;
    b[4 + k] = y * Rq2 - Rq1;
  }
  double AtA[3][3], Atb[3][1];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      double s = 0.0;
#pragma unroll
      for (int r = 0; r < 8; ++r) s += A[r][i] * A[r][j];
      AtA[i][j] = s;
    }
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < 8; ++r) s += A[r][i] * b[r];
    Atb[i][0] = s;
  }
  lu_solve<3, 1>(AtA, Atb);
  t[0] = Atb[0][0];
  t[1] = Atb[1][0];
  t[2] = Atb[2][0];
}

// ippe_square: the candidate of sign `sign`, its translation and its
// squared normalized residual (inf with a corner behind the camera)
__device__ __forceinline__ double ippe_candidate(double sign, const double P[2][2], double b0,
                                                 double b1, const double Rv[3][3],
                                                 const double q[4][2], const double xy[8],
                                                 double R[3][3], double t[3]) {
  double c1[3] = {P[0][0], P[1][0], sign * b0};
  double c2[3] = {P[0][1], P[1][1], sign * b1};
  double c3[3];
  cross3(c1, c2, c3);
  // R = Rv^T [c1 c2 c3]
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    R[i][0] = Rv[0][i] * c1[0] + Rv[1][i] * c1[1] + Rv[2][i] * c1[2];
    R[i][1] = Rv[0][i] * c2[0] + Rv[1][i] * c2[1] + Rv[2][i] * c2[2];
    R[i][2] = Rv[0][i] * c3[0] + Rv[1][i] * c3[1] + Rv[2][i] * c3[2];
  }
  translation_lsq(R, q, xy, t);
  double err2 = 0.0;
  bool any_behind = false, any_nan = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double X = R[0][0] * q[k][0] + R[0][1] * q[k][1] + t[0];
    const double Y = R[1][0] * q[k][0] + R[1][1] * q[k][1] + t[1];
    const double Z = R[2][0] * q[k][0] + R[2][1] * q[k][1] + t[2];
    const double dx = X / Z - xy[2 * k], dy = Y / Z - xy[2 * k + 1];
    err2 += dx * dx + dy * dy;
    any_behind |= Z <= 0.0;
    any_nan |= isnan(Z);
  }
  // amin propagates NaN, and NaN <= 0 is false
  return any_behind && !any_nan ? INFINITY : err2;
}

__device__ __forceinline__ void ippe_square(const double q[4][2], const double xy[8],
                                            double R[3][3], double t[3]) {
  double H[3][3];
  homography(q, xy, H);
  const double v0 = H[0][2], v1 = H[1][2];
  double J[2][2] = {{H[0][0] - v0 * H[2][0], H[0][1] - v0 * H[2][1]},
                    {H[1][0] - v1 * H[2][0], H[1][1] - v1 * H[2][1]}};
  // _rotate_vec_to_z((v0, v1, 1))
  double Rv[3][3];
  {
    double n[3] = {v0, v1, 1.0};
    const double nn = sqrt(dot3(n, n));
#pragma unroll
    for (int i = 0; i < 3; ++i) n[i] = n[i] / nn;
    double ax[3] = {n[1], -n[0], 0.0};
    const double s = sqrt(dot3(ax, ax)), c = n[2];
    if (s > 1e-12) {
      const double cs = clamp_min(s, 1e-12);
      const double w[3] = {ax[0] / cs, ax[1] / cs, ax[2] / cs};
      const double Kx[3][3] = {{0.0, -w[2], w[1]}, {w[2], 0.0, -w[0]}, {-w[1], w[0], 0.0}};
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const double kk = Kx[i][0] * Kx[0][j] + Kx[i][1] * Kx[1][j] + Kx[i][2] * Kx[2][j];
          Rv[i][j] = (i == j ? 1.0 : 0.0) + s * Kx[i][j] + (1.0 - c) * kk;
        }
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) Rv[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  double Bm[2][2] = {{Rv[0][0] - v0 * Rv[0][2], Rv[1][0] - v0 * Rv[1][2]},
                     {Rv[0][1] - v1 * Rv[0][2], Rv[1][1] - v1 * Rv[1][2]}};
  lu_solve<2, 2>(Bm, J);  // J becomes A = Bm^-1 J
  const double (&A)[2][2] = J;
  // the largest singular value of A
  const double ata00 = A[0][0] * A[0][0] + A[1][0] * A[1][0];
  const double ata01 = A[0][0] * A[0][1] + A[1][0] * A[1][1];
  const double ata11 = A[0][1] * A[0][1] + A[1][1] * A[1][1];
  const double tr = ata00 + ata11;
  const double d = ata00 - ata11;
  const double gap = sqrt(clamp_min(d * d + 4.0 * (ata01 * ata01), 0.0));
  const double gamma = sqrt(clamp_min(0.5 * (tr + gap), 1e-30));
  const double P[2][2] = {{A[0][0] / gamma, A[0][1] / gamma}, {A[1][0] / gamma, A[1][1] / gamma}};
  const double b0 = sqrt(clamp_min(1.0 - P[0][0] * P[0][0] - P[1][0] * P[1][0], 0.0));
  double b1 = sqrt(clamp_min(1.0 - P[0][1] * P[0][1] - P[1][1] * P[1][1], 0.0));
  const double sp = -(P[0][0] * P[0][1] + P[1][0] * P[1][1]);
  if (sp < 0) b1 = -b1;
  double R2[3][3], t2[3];
  const double e1 = ippe_candidate(1.0, P, b0, b1, Rv, q, xy, R, t);
  const double e2 = ippe_candidate(-1.0, P, b0, b1, Rv, q, xy, R2, t2);
  if (!(e1 <= e2)) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      t[i] = t2[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = R2[i][j];
    }
  }
}

// iterative_planar's initialization: R ~ [h1/s, h2/s, h1 x h2 / s^2]
// projected onto SO(3), t = h3/s, s = sqrt(|h1||h2|)
__device__ __forceinline__ void homography_init(const double q[4][2], const double xy[8],
                                                double R[3][3], double t[3]) {
  double H[3][3];
  homography(q, xy, H);
  const double h1[3] = {H[0][0], H[1][0], H[2][0]}, h2[3] = {H[0][1], H[1][1], H[2][1]};
  const double s = sqrt(clamp_min(sqrt(dot3(h1, h1)) * sqrt(dot3(h2, h2)), 1e-30));
  double h12[3];
  cross3(h1, h2, h12);
  const double ss = s * s;
  double R0[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    R0[i][0] = h1[i] / s;
    R0[i][1] = h2[i] / s;
    R0[i][2] = h12[i] / ss;
  }
  project_so3(R0, R);
  t[0] = H[0][2] / s;
  t[1] = H[1][2] / s;
  t[2] = H[2][2] / s;
}

// The camera of image b: fx, fy, cx, cy and the 12 modeled coefficients
__device__ __forceinline__ Cam load_cam(const double* __restrict__ Ks,
                                        const double* __restrict__ dists, int b) {
  Cam cam;
  const double* K = Ks + (size_t)b * 9;
  cam.fx = K[0];
  cam.fy = K[4];
  cam.cx = K[2];
  cam.cy = K[5];
#pragma unroll
  for (int k = 0; k < 12; ++k) cam.k[k] = dists[(size_t)b * 14 + k];
  return cam;
}

// A valid slot's ok, R, t and error (o[9:23]); ok where all are finite
__device__ __forceinline__ void write_pose(double* o, const double R[3][3], const double t[3],
                                           double err) {
  bool finite = isfinite(err);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    finite &= isfinite(t[k]);
#pragma unroll
    for (int j = 0; j < 3; ++j) finite &= isfinite(R[k][j]);
  }
  o[9] = finite ? 1.0 : 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) o[10 + 3 * k + j] = R[k][j];
  o[19] = t[0];
  o[20] = t[1];
  o[21] = t[2];
  o[22] = err;
}

// ---------------------------------------------------------------------------
// The kernel: one warp per slot.
//
// Lane roles in the LM: lane 6k + j (k < 4, j < 6) carries tangent j of
// corner k's two residual rows, lane 24 + k corner k's residuals
// themselves, lanes 28-31 repeat lane 27's corner.  Every lane projects its
// corner lane_corner(lane) on a dual number with one tangent.

constexpr int SLOTS = 4;  // slots (warps) a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int lane_corner(int lane) {
  return lane < 24 ? lane / 6 : min(lane - 24, 3);
}

// The lane that holds column c of corner k's two rows (c = 6: the residual)
__device__ __forceinline__ int column_lane(int k, int c) { return c < 6 ? 6 * k + c : 24 + k; }

// The two columns whose products the lane sums over the 8 rows: lanes 0-20
// the upper triangle of J^T J row by row, lanes 21-26 J^T r, 27-31 r^T r
__device__ __forceinline__ void lane_entry(int lane, int& a, int& b) {
  a = 6;
  b = 6;
  if (lane < 21) {
    int r = lane;
    a = 0;
    while (r >= 6 - a) {
      r -= 6 - a;
      ++a;
    }
    b = a + r;
  } else if (lane < 27) {
    a = lane - 21;
  }
}

// The lane's entries of corner k's two rows at p (k = lane_corner(lane)):
// the tangent-j derivatives of u and v on lanes below 24, the residuals u
// - px, v - py on the others.
__device__ __forceinline__ void lm_rows(const double p[6], const Cam& cam, double qx, double qy,
                                        double pu, double pv, int lane, double& cu, double& cv) {
  const int j = lane < 24 ? lane % 6 : 0;
  Dual w[3], tt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w[i].v = p[i];
    w[i].d = j == i ? 1.0 : 0.0;
    tt[i].v = p[3 + i];
    tt[i].d = j == 3 + i ? 1.0 : 0.0;
  }
  Dual R[3][3];
  rodrigues(w, R);
  Dual u, v;
  project(R, tt, cam, qx, qy, u, v);
  cu = lane < 24 ? u.d : u.v - pu;
  cv = lane < 24 ? v.d : v.v - pv;
}

// The LM trial's cost from the residual lanes: the corners' squared
// residuals summed in corner order
__device__ __forceinline__ double warp_cost(double cu, double cv) {
  const double e = cu * cu + cv * cv;
  double cost = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) cost += __shfl_sync(FULL, e, 24 + k);
  return cost;
}

// refine_lm across the warp.  Each trip: the lanes' columns give J^T J,
// J^T r and r^T r, each entry summed by one lane over the 8 rows in the
// plain version's order (corner 0's u row, its v row, corner 1's, ...);
// every lane gathers the 28 sums and solves the damped 6x6 system itself;
// the lanes then evaluate their rows at the trial point, whose residual
// lanes give the trial cost and, if it is accepted, the next trip's rows.
// On return (cu, cv) hold the rows at the final p.
__device__ __forceinline__ void refine_lm(double R[3][3], double t[3], const Cam& cam,
                                          double qx, double qy, double pu, double pv, int lane,
                                          int iters, double& cu, double& cv) {
  int ea, eb;
  lane_entry(lane, ea, eb);
  double p[6];
  so3_log(R, p);
  p[3] = t[0];
  p[4] = t[1];
  p[5] = t[2];
  lm_rows(p, cam, qx, qy, pu, pv, lane, cu, cv);
  double lam = 1e-3;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int la = column_lane(k, ea), lb = column_lane(k, eb);
      s += __shfl_sync(FULL, cu, la) * __shfl_sync(FULL, cu, lb);
      s += __shfl_sync(FULL, cv, la) * __shfl_sync(FULL, cv, lb);
    }
    double A[6][6], g[6][1];
#pragma unroll
    for (int i = 0, e = 0; i < 6; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j, ++e) {
        const double a = __shfl_sync(FULL, s, e);
        A[i][j] = i == j ? a + lam * a + 1e-12 : a;
        A[j][i] = A[i][j];
      }
#pragma unroll
    for (int i = 0; i < 6; ++i) g[i][0] = __shfl_sync(FULL, s, 21 + i);
    const double cost = __shfl_sync(FULL, s, 27);
    lu_solve<6, 1>(A, g);  // g becomes the step
    double pn[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) pn[i] = p[i] - g[i][0];
    double nu, nv;
    lm_rows(pn, cam, qx, qy, pu, pv, lane, nu, nv);
    const bool accept = warp_cost(nu, nv) < cost;
    if (accept) {
#pragma unroll
      for (int i = 0; i < 6; ++i) p[i] = pn[i];
      cu = nu;
      cv = nv;
    }
    lam = clamp(accept ? lam * 0.3 : lam * 3.0, 1e-12, 1e12);
  }
  rodrigues(p, R);
  t[0] = p[3];
  t[1] = p[4];
  t[2] = p[5];
}

__global__ void __launch_bounds__(SLOTS * 32) pnp_block_kernel(
    const double* __restrict__ corners, const long long* __restrict__ ids,
    const unsigned char* __restrict__ valid, const double* __restrict__ Ks,
    const double* __restrict__ dists, double* __restrict__ out, int n, int D, int lm_iters,
    int method, double marker_size) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * SLOTS + (threadIdx.x >> 5);
  if (i >= n) return;
  double* o = out + (size_t)i * 23;
  const double* px = corners + (size_t)i * 8;
  if (lane < 9) o[lane] = lane < 8 ? px[lane] : (double)ids[i];
  if (!valid[i]) {
    if (lane >= 9 && lane < 23) o[lane] = 0.0;
    return;
  }
  const Cam cam = load_cam(Ks, dists, i / D);
  // marker_object_points: TL, TR, BR, BL at half the marker size
  const double h = marker_size * 0.5;
  const double q[4][2] = {{-h, h}, {h, h}, {h, -h}, {-h, -h}};
  const int k = lane_corner(lane);
  const double qx = k == 0 || k == 3 ? -h : h, qy = k < 2 ? h : -h;
  const double pu = px[2 * k], pv = px[2 * k + 1];
  // each lane undistorts its corner; every lane gathers the four
  double x, y, xy[8];
  undistort_corner(pu, pv, cam, x, y);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    xy[2 * c] = __shfl_sync(FULL, x, 6 * c);
    xy[2 * c + 1] = __shfl_sync(FULL, y, 6 * c);
  }
  double R[3][3], t[3], cu, cv;
  if (method == 0)
    ippe_square(q, xy, R, t);
  else
    homography_init(q, xy, R, t);
  for (int pass = 0; pass <= method; ++pass)
    refine_lm(R, t, cam, qx, qy, pu, pv, lane, lm_iters, cu, cv);
  // reprojection_error_max from the residual lanes at the final p (amax
  // propagates NaN, fmax drops it)
  const double e = sqrt(cu * cu + cv * cv);
  double err = 0.0;
  bool any_nan = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const double ec = __shfl_sync(FULL, e, 24 + c);
    any_nan |= isnan(ec);
    err = fmax(err, ec);
  }
  if (any_nan) err = NAN;
  if (lane == 0) write_pose(o, R, t, err);
}

}  // namespace

// One launch per batch of n = B * D slots on `stream`, a warp a slot;
// returns cudaGetLastError().  method: 0 ippe_square, 1 iterative.
extern "C" int pnp_block_f64(const void* corners, const void* ids, const void* valid,
                             const void* Ks, const void* dists, void* out, int n, int D,
                             int lm_iters, int method, double marker_size, void* stream) {
  if (n <= 0 || D <= 0 || n % D || lm_iters < 0 || (method != 0 && method != 1))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + SLOTS - 1) / SLOTS;
  pnp_block_kernel<<<blocks, SLOTS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(corners), static_cast<const long long*>(ids),
      static_cast<const unsigned char*>(valid), static_cast<const double*>(Ks),
      static_cast<const double*>(dists), static_cast<double*>(out), n, D, lm_iters, method,
      marker_size);
  return (int)cudaGetLastError();
}

extern "C" const char* pnp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
