// Refine, decode and dedup of a batch's quad candidates, float64, on Hopper
// (sm_90a): a block a candidate slot, then a block a frame.
//
// Replaces the detect program of vican_tpu/perception.py:939
// _build_hybrid, less its PnP (csrc/pnp.cu): refine_quad
// (vican_tpu/ops/detect.py:727 refine_corners, :787 refine_corners_subpix),
// decode_quads (:890 decode_one, vmapped at :969) and dedup_and_compact
// (:988), which XLA compiles into one program with PnP; no Pallas kernel
// computes it.  The plain PyTorch version is
// vican_torch/ops/detect.py:detect_candidates_plain (~560 eager launches
// and a host sync a 32-frame batch); this file computes the same function
// in two launches and no host sync.
//
// Operands (see vican_torch/ops/detect.py:detect_candidates):
//   gray (B, H, W) uint8; quads (B*Q, 4, 2) f32, valid (B*Q)
//   bool, areas (B*Q) f32: the candidates and their dedup score; codes
//   (ncodes,) int64: the dictionary's (id, rotation) words; tab f64: the
//   plain version's own tables (edge-fit sample positions and probe
//   offsets, cornerSubPix weights, decode sample positions at frac 1 and
//   0.5), made by it on the card.
//   Scratch: each slot's refined corners rolled to the canonical order
//   (B*Q, 4, 2) f64, id (B*Q) int64 and decode verdict (B*Q) bool; a slot
//   that is not valid is never written.
//   Out (Detections): corners (B, D, 4, 2) f64, ids (B, D) int64, valid
//   (B, D) bool, score (B, D) f32.
//
// detect_slots_kernel, a block of 128 threads a slot of all B*Q (a slot
// that is not valid returns at once, which replaces the plain version's
// nonzero and its host sync), reads the slot's uint8 frame where it
// samples, each grey level cast to double as the plain version casts it:
//   refine 1 (apriltag): the 4 edges x S samples x O offsets x 2 bilinear
//     probes, a thread an (edge, sample) summing its offsets in order; a
//     thread an edge for the weighted centroid, covariance and the closed
//     form dominant direction with its (0, 1) fallback; a thread a corner
//     for the 1e-12-regularized intersection and the clamp;
//   refine 2 (subpix): the 4 corners iterate together until each stops
//     (its step under subpix_acc, or subpix_iters trips), a stopped corner
//     frozen, as the plain version steps them; the window's 5 products a
//     thread a pixel, each sum a thread's; refine 0: the quad as it is;
//   decode: the 4-point homography (an 8x8 LU, partial pivoting; one
//     thread), then an attempt over whole cells and, for a slot it
//     rejects, one over their central half: (n_bits + 2)^2 cells x Sd^2
//     bilinear samples spread over the threads, the 64-bin Otsu (min, max,
//     histogram, one thread's cumulative sums, the first argmax), the
//     per-cell majority, the border and contrast gates, and the dictionary
//     by XOR and popcount, the first index of the least distance.
// dedup_kernel, a block of 256 threads a frame: the Q x Q close-and-better
// suppression (larger area, then the lower index), then a slot's place in
// the stable order by -area (the kept first) by counting, and the first D.
//
// Numerics: float64 as the plain version, built with --fmad=false
// (vican_torch/_kernels.py), and every expression written in the plain
// version's order, so each elementwise step rounds as torch's does: the
// bilinear formula, the sample coordinates, the Otsu bin index, the gates,
// det > 1e-6, the clamp, the dedup radius in float32.  Sums over samples
// (centroids, covariances, means, the cornerSubPix sums) are sequential,
// torch's reductions take another order: corners then differ by rounding,
// and a compare sitting on its bar within rounding could go the other way.
//
// What bounds it: operations, in float64.  A valid apriltag slot takes
// ~2.2e4 (640 bilinear probes and the fits) and ~4.5e4 an attempt of 900
// samples, plus 4000 popcounts; the smoke's first batch of P holds 2842
// valid slots of 5376, 1334 of them taking the second attempt: ~2.6e8
// operations, ~7.6 us at 34 TFLOP/s (chip_smoke.py:_detect_work), with
// ~23 MB of operands.  This design is far from it: a slot is a chain of
// short parallel steps joined by block barriers, with one thread's serial
// tails (the homography's LU, Otsu's cumulative sums, the partial
// reductions), so the kernel's time is about a slot's chain times the
// blocks over what the card holds at once (PERF.md §6-§7).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SLOT_THREADS = 128;
constexpr int FRAME_THREADS = 256;
constexpr int BINS = 64;           // Otsu's histogram
constexpr int MAX_SAMPLES = 64;    // refine_samples
constexpr int MAX_CELLS2 = 100;    // (n_bits + 2)^2: the dictionaries up to 8x8
constexpr double PROBE_STEP = 0.7;  // refine_corners' gradient probe, px

enum { REFINE_NONE = 0, REFINE_APRILTAG = 1, REFINE_SUBPIX = 2 };

struct Params {
  int H, W, Q, refine, S, O, win, iters, n_bits, Sd, max_border_errs, ec_bits, ncodes;
  double subpix_acc, clamp_px, min_cell_contrast;
};

// The slot's block state beside its float64 scratch (dynamic shared).
struct SlotShared {
  double q[4][2];     // the candidate, float64
  double ref[4][2];   // its refined corners
  double nrm[4][2], mean[4][2];  // each edge's fitted line
  double cur[4][2], move[4], sums[4][5];  // cornerSubPix's state
  double Hm[9];       // the homography, row-major, Hm[8] = 1
  double lo[SLOT_THREADS], hi[SLOT_THREADS];
  double vlo, tau;
  double means[MAX_CELLS2];
  int hist[BINS];
  int bestd[SLOT_THREADS], bestj[SLOT_THREADS];
  unsigned char bits[MAX_CELLS2];
  long long word;
  int gates, ok, best;
};

// torch.clamp_min: a NaN stays NaN
__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }

// vican_torch/ops/detect.py:_bilinear: nan_to_num, then the clamp to
// [0, W - 1.001] x [0, H - 1.001] (fmax sends a NaN to the low bound, and
// a bound takes +-inf as nan_to_num's +-max does), the four neighbours as
// float64, the weights in the plain version's order.
__device__ __forceinline__ double bilinear(const unsigned char* __restrict__ g, int H, int W,
                                           double x, double y) {
  x = fmin(fmax(x, 0.0), (double)W - 1.001);
  y = fmin(fmax(y, 0.0), (double)H - 1.001);
  const double x0 = floor(x), y0 = floor(y);
  const double fx = x - x0, fy = y - y0;
  const unsigned char* px = g + (long long)y0 * W + (long long)x0;
  const double v00 = (double)px[0], v01 = (double)px[1];
  const double v10 = (double)px[W], v11 = (double)px[W + 1];
  return v00 * (1.0 - fx) * (1.0 - fy) + v01 * fx * (1.0 - fy) + v10 * (1.0 - fx) * fy +
         v11 * fx * fy;
}

// refine_corners (AprilTag edge fits) of sh.q into sh.ref.  scratch holds
// each (edge, sample)'s summed weight and centroid.
__device__ void refine_apriltag(const unsigned char* __restrict__ g, const Params& p,
                                const double* __restrict__ tab, SlotShared& sh,
                                double* scratch) {
  const int tid = threadIdx.x, S = p.S;
  const double* ts = tab;
  const double* offs = tab + S;
  double* ssw = scratch;
  double* scx = scratch + 4 * S;
  double* scy = scratch + 8 * S;
  for (int es = tid; es < 4 * S; es += SLOT_THREADS) {
    const int e = es / S, s = es % S, e1 = (e + 1) & 3;
    const double ax = sh.q[e][0], ay = sh.q[e][1];
    const double dx = sh.q[e1][0] - ax, dy = sh.q[e1][1] - ay;
    const double len = clamp_min(sqrt(dx * dx + dy * dy), 1e-6);
    const double nx = -dy / len, ny = dx / len;
    const double bx = ax + ts[s] * dx, by = ay + ts[s] * dy;
    double sw = 0.0, cx = 0.0, cy = 0.0;
    for (int o = 0; o < p.O; ++o) {
      const double px = bx + offs[o] * nx, py = by + offs[o] * ny;
      const double gp = bilinear(g, p.H, p.W, px + PROBE_STEP * nx, py + PROBE_STEP * ny);
      const double gm = bilinear(g, p.H, p.W, px - PROBE_STEP * nx, py - PROBE_STEP * ny);
      const double w = fabs(gp - gm);
      sw += w;
      cx += w * px;
      cy += w * py;
    }
    const double wsum = clamp_min(sw, 1e-6);
    ssw[es] = sw;
    scx[es] = cx / wsum;
    scy[es] = cy / wsum;
  }
  __syncthreads();
  if (tid < 4) {
    const int e = tid, e1 = (e + 1) & 3;
    const double* sw = ssw + e * S;
    const double* cx = scx + e * S;
    const double* cy = scy + e * S;
    double tot = 0.0;
    for (int s = 0; s < S; ++s) tot += sw[s];
    const double den = clamp_min(tot, 1e-6);
    double mx = 0.0, my = 0.0;
    for (int s = 0; s < S; ++s) {
      const double wn = sw[s] / den;
      mx += wn * cx[s];
      my += wn * cy[s];
    }
    double a = 0.0, b = 0.0, c = 0.0;
    for (int s = 0; s < S; ++s) {
      const double wn = sw[s] / den, dcx = cx[s] - mx, dcy = cy[s] - my;
      a += wn * dcx * dcx;
      b += wn * dcx * dcy;
      c += wn * dcy * dcy;
    }
    // _dominant_direction: the largest eigenvalue's unit eigenvector
    const double amc = a - c;
    const double lam = 0.5 * (a + c) + sqrt(0.25 * (amc * amc) + b * b);
    const double v1x = lam - c, v1y = b, v2x = b, v2y = lam - a;
    const double n1 = sqrt(v1x * v1x + v1y * v1y), n2 = sqrt(v2x * v2x + v2y * v2y);
    const bool first = n1 >= n2;
    const double vx = first ? v1x : v2x, vy = first ? v1y : v2y;
    const double n = (n1 != n1 || n2 != n2) ? n1 + n2 : (n1 > n2 ? n1 : n2);
    double dirx = 0.0, diry = 1.0;
    if (n > 0) {
      const double nn = clamp_min(n, 1e-300);
      dirx = vx / nn;
      diry = vy / nn;
    }
    const double ax = sh.q[e][0], ay = sh.q[e][1], ex = sh.q[e1][0], ey = sh.q[e1][1];
    if (tot > 1e-3 * S) {
      sh.nrm[e][0] = -diry;
      sh.nrm[e][1] = dirx;
      sh.mean[e][0] = mx;
      sh.mean[e][1] = my;
    } else {  // washed-out gradients: the coarse edge
      const double dx = ex - ax, dy = ey - ay;
      const double len = clamp_min(sqrt(dx * dx + dy * dy), 1e-6);
      sh.nrm[e][0] = -dy / len;
      sh.nrm[e][1] = dx / len;
      sh.mean[e][0] = (ax + ex) * 0.5;
      sh.mean[e][1] = (ay + ey) * 0.5;
    }
  }
  __syncthreads();
  if (tid < 4) {  // corner k: edges k - 1 and k
    const int k = tid, km = (k + 3) & 3;
    const double n1x = sh.nrm[km][0], n1y = sh.nrm[km][1];
    const double n2x = sh.nrm[k][0], n2y = sh.nrm[k][1];
    const double r1 = n1x * sh.mean[km][0] + n1y * sh.mean[km][1];
    const double r2 = n2x * sh.mean[k][0] + n2y * sh.mean[k][1];
    const double det = n1x * n2y - n1y * n2x;
    const double a00 = n1x + 1e-12, a01 = n1y, a10 = n2x, a11 = n2y + 1e-12;
    const double det_r = a00 * a11 - a01 * a10;
    const double qx = sh.q[k][0], qy = sh.q[k][1];
    double rx = qx, ry = qy;
    if (fabs(det) > 1e-6) {
      rx = (r1 * a11 - a01 * r2) / det_r;
      ry = (a00 * r2 - a10 * r1) / det_r;
    }
    const double ddx = rx - qx, ddy = ry - qy;
    const bool keep = sqrt(ddx * ddx + ddy * ddy) < p.clamp_px;
    sh.ref[k][0] = keep ? rx : qx;
    sh.ref[k][1] = keep ? ry : qy;
  }
}

// refine_corners_subpix of sh.q into sh.ref.  scratch holds each window
// pixel's five products, corner by corner.
__device__ void refine_subpix(const unsigned char* __restrict__ g, const Params& p,
                              const double* __restrict__ wtab, SlotShared& sh,
                              double* scratch) {
  const int tid = threadIdx.x, side = 2 * p.win + 1, P = side * side;
  if (tid < 4) {
    sh.cur[tid][0] = sh.q[tid][0];
    sh.cur[tid][1] = sh.q[tid][1];
    sh.move[tid] = INFINITY;
  }
  for (int it = 0; it < p.iters; ++it) {
    __syncthreads();
    bool any = false;
    for (int k = 0; k < 4; ++k) any |= sh.move[k] >= p.subpix_acc;
    if (!any) break;
    for (int i = tid; i < 4 * P; i += SLOT_THREADS) {
      const int k = i / P, idx = i % P;
      if (!(sh.move[k] >= p.subpix_acc)) continue;
      const double px = sh.cur[k][0] + (double)(idx % side - p.win);
      const double py = sh.cur[k][1] + (double)(idx / side - p.win);
      const double gx =
          (bilinear(g, p.H, p.W, px + 1.0, py) - bilinear(g, p.H, p.W, px - 1.0, py)) * 0.5;
      const double gy =
          (bilinear(g, p.H, p.W, px, py + 1.0) - bilinear(g, p.H, p.W, px, py - 1.0)) * 0.5;
      const double w = wtab[idx];
      double* out = scratch + k * 5 * P + idx;
      out[0] = w * gx * gx;
      out[P] = w * gx * gy;
      out[2 * P] = w * gy * gy;
      out[3 * P] = w * (gx * gx * px + gx * gy * py);
      out[4 * P] = w * (gx * gy * px + gy * gy * py);
    }
    __syncthreads();
    if (tid < 20 && sh.move[tid / 5] >= p.subpix_acc) {
      const double* in = scratch + tid * P;
      double acc = 0.0;
      for (int i = 0; i < P; ++i) acc += in[i];
      sh.sums[tid / 5][tid % 5] = acc;
    }
    __syncthreads();
    if (tid < 4 && sh.move[tid] >= p.subpix_acc) {
      const double* m = sh.sums[tid];
      const double gxx = m[0], gxy = m[1], gyy = m[2], bx = m[3], by = m[4];
      const double det = gxx * gyy - gxy * gxy;
      const double den = det == 0.0 ? 1.0 : det;
      const double qx = sh.cur[tid][0], qy = sh.cur[tid][1];
      double nx = qx, ny = qy;
      if (fabs(det) > 1e-9) {
        nx = (gyy * bx - gxy * by) / den;
        ny = (-gxy * bx + gxx * by) / den;
      }
      const double sx = nx - qx, sy = ny - qy;
      sh.cur[tid][0] = nx;
      sh.cur[tid][1] = ny;
      sh.move[tid] = sqrt(sx * sx + sy * sy);
    }
  }
  __syncthreads();
  if (tid < 4) {
    const double dx = sh.cur[tid][0] - sh.q[tid][0], dy = sh.cur[tid][1] - sh.q[tid][1];
    const bool keep = sqrt(dx * dx + dy * dy) < p.clamp_px;
    sh.ref[tid][0] = keep ? sh.cur[tid][0] : sh.q[tid][0];
    sh.ref[tid][1] = keep ? sh.cur[tid][1] : sh.q[tid][1];
  }
}

// ops/pnp.py:homography_4pt from the marker grid's corners (0, 0), (c, 0),
// (c, c), (0, c) to sh.ref: the 8x8 DLT system in its row order, solved by
// LU with partial pivoting (the first largest pivot).  One thread.
__device__ void homography(SlotShared& sh, double c) {
  const double sx[4] = {0.0, c, c, 0.0}, sy[4] = {0.0, 0.0, c, c};
  double A[8][8], r[8];
  for (int i = 0; i < 4; ++i) {
    const double x = sx[i], y = sy[i], u = sh.ref[i][0], v = sh.ref[i][1];
    const double ra[8] = {x, y, 1.0, 0.0, 0.0, 0.0, -u * x, -u * y};
    const double rb[8] = {0.0, 0.0, 0.0, x, y, 1.0, -v * x, -v * y};
    for (int j = 0; j < 8; ++j) {
      A[2 * i][j] = ra[j];
      A[2 * i + 1][j] = rb[j];
    }
    r[2 * i] = u;
    r[2 * i + 1] = v;
  }
  for (int k = 0; k < 8; ++k) {
    int piv = k;
    for (int i = k + 1; i < 8; ++i)
      if (fabs(A[i][k]) > fabs(A[piv][k])) piv = i;
    if (piv != k) {
      for (int j = 0; j < 8; ++j) {
        const double t = A[k][j];
        A[k][j] = A[piv][j];
        A[piv][j] = t;
      }
      const double t = r[k];
      r[k] = r[piv];
      r[piv] = t;
    }
    for (int i = k + 1; i < 8; ++i) {
      const double f = A[i][k] / A[k][k];
      for (int j = k + 1; j < 8; ++j) A[i][j] -= f * A[k][j];
      r[i] -= f * r[k];
    }
  }
  double h[8];
  for (int k = 7; k >= 0; --k) {
    double acc = r[k];
    for (int j = k + 1; j < 8; ++j) acc -= A[k][j] * h[j];
    h[k] = acc / A[k][k];
  }
  for (int k = 0; k < 8; ++k) sh.Hm[k] = h[k];
  sh.Hm[8] = 1.0;
}

// One sampling pass of decode_quads (_decode_attempt and its gates) with
// the cell positions lin: sets sh.ok and sh.best (the first index of the
// least Hamming distance in codes).  scratch holds the samples, cell by
// cell, each cell's rows of Sd.
__device__ void decode_attempt(const unsigned char* __restrict__ g, const Params& p,
                               const double* __restrict__ lin,
                               const long long* __restrict__ codes, SlotShared& sh,
                               double* samp) {
  const int tid = threadIdx.x, cells = p.n_bits + 2, per = p.Sd * p.Sd;
  const int n = cells * cells * per;
  const double* H = sh.Hm;
  double lo = INFINITY, hi = -INFINITY;
  for (int i = tid; i < n; i += SLOT_THREADS) {
    const int cell = i / per, r = cell / cells, c = cell % cells;
    const double u = (double)c + lin[i % p.Sd], v = (double)r + lin[(i % per) / p.Sd];
    const double pz = H[6] * u + H[7] * v + H[8];
    const double x = (H[0] * u + H[1] * v + H[2]) / pz;
    const double y = (H[3] * u + H[4] * v + H[5]) / pz;
    const double s = bilinear(g, p.H, p.W, x, y);
    samp[i] = s;
    lo = fmin(lo, s);
    hi = fmax(hi, s);
  }
  sh.lo[tid] = lo;
  sh.hi[tid] = hi;
  if (tid < BINS) sh.hist[tid] = 0;
  __syncthreads();
  if (tid == 0) {
    for (int t = 1; t < SLOT_THREADS; ++t) {
      lo = fmin(lo, sh.lo[t]);
      hi = fmax(hi, sh.hi[t]);
    }
    sh.vlo = lo;
    sh.tau = hi;  // the maximum, until Otsu's threshold replaces it
  }
  __syncthreads();
  const double vlo = sh.vlo, span = clamp_min(sh.tau - vlo, 1e-6);
  for (int i = tid; i < n; i += SLOT_THREADS) {
    int b = (int)((samp[i] - vlo) / span * BINS);
    b = b < 0 ? 0 : (b > BINS - 1 ? BINS - 1 : b);
    atomicAdd(&sh.hist[b], 1);
  }
  if (tid < cells * cells) {
    double m = 0.0;
    for (int k = 0; k < per; ++k) m += samp[tid * per + k];
    sh.means[tid] = m / per;
  }
  __syncthreads();
  if (tid == 0) {  // _otsu: cumulative sums in bin order, the first argmax
    const double step = span / BINS;
    double s_all = 0.0;
    for (int k = 0; k < BINS; ++k) s_all += (double)sh.hist[k] * (vlo + ((double)k + 0.5) * step);
    const double w_all = (double)n;
    double w0 = 0.0, s0 = 0.0, best = 0.0;
    int bk = 0;
    for (int k = 0; k < BINS; ++k) {
      const double h = (double)sh.hist[k];
      w0 += h;
      s0 += h * (vlo + ((double)k + 0.5) * step);
      const double w1 = w_all - w0;
      const double mu0 = s0 / clamp_min(w0, 1e-6);
      const double mu1 = (s_all - s0) / clamp_min(w1, 1e-6);
      const double d = mu0 - mu1;
      const double var = w0 * w1 * (d * d);
      if (k == 0 || var > best) {
        best = var;
        bk = k;
      }
    }
    sh.tau = vlo + ((double)bk + 1.0) * step;
  }
  __syncthreads();
  if (tid < cells * cells) {
    const double tau = sh.tau;
    int above = 0;
    for (int k = 0; k < per; ++k) above += samp[tid * per + k] > tau;
    sh.bits[tid] = 2 * above > per;
  }
  __syncthreads();
  if (tid == 0) {
    int errs = 0;
    double mx = -INFINITY, mn = INFINITY;
    long long word = 0;
    for (int r = 0; r < cells; ++r)
      for (int c = 0; c < cells; ++c) {
        const int k = r * cells + c;
        const bool border = r == 0 || c == 0 || r == cells - 1 || c == cells - 1;
        if (border)
          errs += sh.bits[k];
        else if (sh.bits[k])
          word |= 1LL << ((r - 1) * p.n_bits + (c - 1));
        mx = fmax(mx, sh.means[k]);
        mn = fmin(mn, sh.means[k]);
      }
    sh.word = word;
    sh.gates = errs <= p.max_border_errs && (mx - mn) > p.min_cell_contrast;
  }
  __syncthreads();
  const long long word = sh.word;
  int bd = 1 << 30, bj = 0;
  for (int j = tid; j < p.ncodes; j += SLOT_THREADS) {
    const int d = __popcll((unsigned long long)(word ^ codes[j]));
    if (d < bd) {
      bd = d;
      bj = j;
    }
  }
  sh.bestd[tid] = bd;
  sh.bestj[tid] = bj;
  __syncthreads();
  if (tid == 0) {
    for (int t = 1; t < SLOT_THREADS; ++t)
      if (sh.bestd[t] < bd || (sh.bestd[t] == bd && sh.bestj[t] < bj)) {
        bd = sh.bestd[t];
        bj = sh.bestj[t];
      }
    sh.ok = sh.gates && bd <= p.ec_bits;
    sh.best = bj;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(SLOT_THREADS)
    detect_slots_kernel(const unsigned char* __restrict__ gray, const float* __restrict__ quads,
                        const unsigned char* __restrict__ valid,
                        const long long* __restrict__ codes, const double* __restrict__ tab,
                        double* __restrict__ slot_corners, long long* __restrict__ slot_ids,
                        unsigned char* __restrict__ slot_ok, Params p) {
  extern __shared__ double scratch[];
  __shared__ SlotShared sh;
  const long long slot = blockIdx.x;
  if (!valid[slot]) return;
  const int tid = threadIdx.x;
  const unsigned char* g = gray + (slot / p.Q) * (long long)p.H * p.W;
  if (tid < 8) {
    const double v = (double)quads[slot * 8 + tid];
    sh.q[tid >> 1][tid & 1] = v;
    sh.ref[tid >> 1][tid & 1] = v;
  }
  __syncthreads();
  const int P = (2 * p.win + 1) * (2 * p.win + 1);
  if (p.refine == REFINE_APRILTAG)
    refine_apriltag(g, p, tab, sh, scratch);
  else if (p.refine == REFINE_SUBPIX)
    refine_subpix(g, p, tab + p.S + p.O, sh, scratch);
  __syncthreads();
  if (tid == 0) homography(sh, (double)(p.n_bits + 2));
  __syncthreads();
  const double* lin = tab + p.S + p.O + P;
  decode_attempt(g, p, lin, codes, sh, scratch);
  const int ok1 = sh.ok, best1 = sh.best;
  int ok = ok1, best = best1;
  if (!ok1) {  // the central half of each cell (vican_tpu/ops/detect.py:958-962)
    decode_attempt(g, p, lin + p.Sd, codes, sh, scratch);
    ok = sh.ok;
    best = sh.best;
  }
  if (tid < 8) {  // corner k is refined corner (k + rotation) % 4
    const int k = tid >> 1, src = (k + best % 4) & 3;
    slot_corners[slot * 8 + tid] = sh.ref[src][tid & 1];
  }
  if (tid == 0) {
    slot_ids[slot] = best / 4;
    slot_ok[slot] = ok;
  }
}

// dedup_and_compact of one frame's Q slots into its D outputs.
__global__ void __launch_bounds__(FRAME_THREADS)
    dedup_kernel(const unsigned char* __restrict__ valid, const float* __restrict__ areas,
                 const double* __restrict__ slot_corners,
                 const long long* __restrict__ slot_ids,
                 const unsigned char* __restrict__ slot_ok, double* __restrict__ corners,
                 long long* __restrict__ ids, unsigned char* __restrict__ keep_out,
                 float* __restrict__ score, int Q, int D, float rate) {
  extern __shared__ double fs[];
  double* cx = fs;
  double* cy = cx + Q;
  float* area = reinterpret_cast<float*>(cy + Q);
  float* edge = area + Q;
  unsigned char* ok = reinterpret_cast<unsigned char*>(edge + Q);
  unsigned char* keep = ok + Q;
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * Q;
  for (int i = tid; i < Q; i += FRAME_THREADS) {
    const bool v = valid[base + i];
    const double* c = slot_corners + (base + i) * 8;
    // corners.mean(dim=2); a slot that is not valid has zero corners
    cx[i] = v ? (c[0] + c[2] + c[4] + c[6]) / 4.0 : 0.0;
    cy[i] = v ? (c[1] + c[3] + c[5] + c[7]) / 4.0 : 0.0;
    const float a = areas[base + i];
    area[i] = a;
    edge[i] = sqrtf(a < 1.0f ? 1.0f : a);
    ok[i] = v && slot_ok[base + i];
  }
  __syncthreads();
  for (int i = tid; i < Q; i += FRAME_THREADS) {
    bool suppressed = false;
    for (int j = 0; ok[i] && j < Q && !suppressed; ++j) {
      if (!ok[j]) continue;
      const float r = rate * fminf(edge[i], edge[j]);
      const double dx = cx[i] - cx[j], dy = cy[i] - cy[j];
      const bool close = dx * dx + dy * dy < (double)(r * r);
      suppressed = close && (area[j] > area[i] || (area[j] == area[i] && j < i));
    }
    keep[i] = ok[i] && !suppressed;
  }
  __syncthreads();
  for (int i = tid; i < Q; i += FRAME_THREADS) {
    // the slot's place in the stable ascending order of (kept ? -area : inf)
    int rank = 0;
    for (int j = 0; j < Q; ++j) {
      if (keep[i])
        rank += keep[j] && (area[j] > area[i] || (area[j] == area[i] && j < i));
      else
        rank += keep[j] || j < i;
    }
    if (rank >= D) continue;
    const long long o = (long long)blockIdx.x * D + rank;
    const bool v = valid[base + i];
    for (int k = 0; k < 8; ++k) corners[o * 8 + k] = v ? slot_corners[(base + i) * 8 + k] : 0.0;
    ids[o] = v ? slot_ids[base + i] : 0;
    keep_out[o] = keep[i];
    score[o] = area[i];
  }
}

}  // namespace

extern "C" int detect_candidates_f64(
    const void* gray, const void* quads, const void* valid, const void* areas, const void* codes,
    const void* tab, void* slot_corners, void* slot_ids, void* slot_ok, void* corners, void* ids,
    void* keep, void* score, int B, int H, int W, int Q, int D, int refine, int S,
    int O, int win, int iters, int n_bits, int Sd, int max_border_errs, int ec_bits, int ncodes,
    double subpix_acc, double clamp_px, double min_cell_contrast, float dedup_rate,
    void* stream) {
  const int cells2 = (n_bits + 2) * (n_bits + 2), P = (2 * win + 1) * (2 * win + 1);
  // sizes past the shared arrays, the 48 KB a block or a 62-bit code
  if (B <= 0 || Q <= 0 || D <= 0 || D > Q || H < 2 || W < 2 || n_bits < 1 ||
      cells2 > MAX_CELLS2 || S < 1 || S > MAX_SAMPLES || O < 1 || win < 1 || iters < 0 ||
      Sd < 1 || n_bits * n_bits > 62 || ncodes < 1 || refine < REFINE_NONE ||
      refine > REFINE_SUBPIX)
    return (int)cudaErrorInvalidValue;
  int scratch = cells2 * Sd * Sd;
  if (refine == REFINE_APRILTAG && 12 * S > scratch) scratch = 12 * S;
  if (refine == REFINE_SUBPIX && 20 * P > scratch) scratch = 20 * P;
  const size_t slot_smem = (size_t)scratch * sizeof(double);
  const size_t frame_smem = (size_t)Q * (2 * sizeof(double) + 2 * sizeof(float) + 2);
  if (slot_smem + sizeof(SlotShared) > 48 * 1024 || frame_smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const Params p{H, W, Q, refine, S, O, win, iters, n_bits, Sd, max_border_errs, ec_bits,
                 ncodes, subpix_acc, clamp_px, min_cell_contrast};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const float*>(quads);
  const auto* v = static_cast<const unsigned char*>(valid);
  const auto* cd = static_cast<const long long*>(codes);
  const auto* tb = static_cast<const double*>(tab);
  auto* sc = static_cast<double*>(slot_corners);
  auto* si = static_cast<long long*>(slot_ids);
  auto* so = static_cast<unsigned char*>(slot_ok);
  const unsigned slots = (unsigned)B * (unsigned)Q;
  detect_slots_kernel<<<slots, SLOT_THREADS, slot_smem, s>>>(
      static_cast<const unsigned char*>(gray), q, v, cd, tb, sc, si, so, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dedup_kernel<<<B, FRAME_THREADS, frame_smem, s>>>(
      v, static_cast<const float*>(areas), sc, si, so, static_cast<double*>(corners),
      static_cast<long long*>(ids), static_cast<unsigned char*>(keep),
      static_cast<float*>(score), Q, D, dedup_rate);
  return (int)cudaGetLastError();
}

extern "C" const char* detect_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
