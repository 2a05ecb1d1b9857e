// Refine, decode and dedup of a batch's quad candidates, float64, on Hopper
// (sm_90a): a warp a candidate slot, then a block a frame with a warp a row.
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
// detect_slots_kernel, a block of one warp a slot of all B*Q (a warp whose
// slot is not valid returns at once, which replaces the plain version's
// nonzero and its host sync, and frees its block's place for a valid one),
// reads the slot's uint8 frame where it samples, each grey level cast to
// double as the plain version casts it.  Its steps are joined by
// __syncwarp, shuffles and votes, never by a block barrier:
//   refine 1 (apriltag): lanes 8e..8e+7 own edge e; a lane probes every
//     8th of its edge's S samples (O offsets x 2 bilinear probes each,
//     summed in order), the weighted centroid and covariance are its
//     partial sums reduced over the 8 lanes, then each lane has its edge's
//     closed-form direction and lane k & 3 intersects corner k's two edges;
//   refine 2 (subpix): the corners step together until each stops (its
//     step under subpix_acc, or subpix_iters trips), a stopped corner
//     frozen, as the plain version steps them; a trip spreads the corners
//     still moving over the warp (32, 16 or 8 lanes a corner), a lane every
//     G-th pixel of its corner's window, the five sums over its G lanes;
//     refine 0: the quad as it is;
//   the homography: the 8x8 DLT system a row a lane, LU with partial
//     pivoting (the first largest pivot by a shuffle argmax over lanes 0-7,
//     swaps as lane relabelings, each update written as the one-thread LU
//     writes it), the back substitution broadcasting each unknown;
//   decode: an attempt over whole cells and, for a slot it rejects, one
//     over their central half: (n_bits + 2)^2 cells x Sd^2 bilinear
//     samples, lane k a cell's sample k, a cell at a time, kept in the
//     warp's shared memory; min and max by shuffles; each sample's bin, then
//     the 64-bin histogram by ballots (seven a round of 32 samples give
//     every lane's bin bits, and lane l counts bins 2 l and 2 l + 1: no
//     shared counts, no atomics); Otsu with a lane owning 2 bins (integer
//     and float64 prefix sums by shuffles, the first argmax by a
//     lexicographic (var, -bin) shuffle tree); a cell a lane for its mean
//     and majority, the border errors by ballot, the word by OR shuffles;
//     the dictionary by XOR and popcount over the lanes, 8 loads in flight,
//     stopping once a code at distance 0 is seen, and the first index of
//     the least distance by a lexicographic (distance, index) tree.
// dedup_kernel, a block of FRAME_THREADS a frame, a warp a slot i and its
// lanes the slots j in chunks of 32: the close-and-better suppression
// (larger area, then the lower index) by __any_sync, then the slot's place
// in the stable order by -area (the kept first) by ballot counts, and the
// first D.
//
// Numerics: float64 as the plain version, built with --fmad=false
// (vican_torch/_kernels.py), and every expression written in the plain
// version's order, so each elementwise step rounds as torch's does: the
// bilinear formula, the sample coordinates, the Otsu bin index, the gates,
// det > 1e-6, the clamp, the dedup radius in float32.  Min, max, counts
// and the lexicographic argmax and argmin are exact in any order.  Sums
// over samples (centroids, covariances, the Otsu prefix, the cell means,
// the cornerSubPix sums) run in another order than torch's reductions:
// corners then differ by rounding, and a compare sitting on its bar within
// rounding could go the other way.
//
// What bounds it: operations, in float64.  A valid apriltag slot takes
// ~2.2e4 (640 bilinear probes and the fits) and ~4.5e4 an attempt of 900
// samples, plus up to 4000 popcounts; the smoke's first batch of P holds
// 2842 valid slots of 5376, 1334 of them taking the second attempt:
// ~2.6e8 operations, ~7.6 us at 34 TFLOP/s (tools/kernel_times.py:detect_work),
// with ~23 MB of operands.  No design reaches that: a slot is a dependent
// chain (the LU's 8 pivot steps and 8 back substitutions, each with its
// division; ~36 samples a lane an attempt, each a division and a gather;
// the histogram's rounds), ~44 us alone for a slot that decodes at once
// and ~80 us for one that takes two attempts (PERF.md §6).  The design
// keeps every valid slot resident at once (88 registers, no spill: 23
// warps an SM hold P's batch), so the kernel's time is the longest chain
// slowed by what the SMs share (PERF.md §6-§7).
#include <cuda_runtime.h>
#include <math.h>

// The blocks' dynamic shared memory: a region a warp (WarpState, then its
// scratch) in detect_slots_kernel, the frame's arrays in dedup_kernel.
extern __shared__ double detect_smem[];

namespace {

constexpr unsigned FULL = 0xffffffffu;
// slots a block of detect_slots_kernel: 2 and 4 measured slower, a block of
// a valid slot and one that is not holding its place for the valid one
constexpr int SLOT_WARPS = 1;
constexpr int FRAME_THREADS = 1024;   // dedup_kernel: 32 warps a frame
constexpr int BINS = 64;              // Otsu's histogram, 2 bins a lane
constexpr int MAX_SAMPLES = 64;       // refine_samples
constexpr int MAX_CELLS2 = 100;       // (n_bits + 2)^2: the dictionaries up to 8x8
constexpr double PROBE_STEP = 0.7;    // refine_corners' gradient probe, px

enum { REFINE_NONE = 0, REFINE_APRILTAG = 1, REFINE_SUBPIX = 2 };

struct Params {
  int slots, H, W, Q, refine, S, O, win, iters, n_bits, Sd, max_border_errs, ec_bits, ncodes;
  int warp_doubles;  // a warp's shared region: WarpState, then its scratch
  double subpix_acc, clamp_px, min_cell_contrast;
  double xmax, ymax;  // the bilinear clamp: W - 1.001, H - 1.001
};

// A warp's slot state, at the head of its shared region.
struct WarpState {
  double ref[4][2];  // the refined corners
  double cur[4][2];  // cornerSubPix's corners and their last steps
  double move[4];
  double Hm[9];      // the homography, row-major, Hm[8] = 1
};
constexpr int STATE_DOUBLES = sizeof(WarpState) / sizeof(double);
static_assert(sizeof(WarpState) % sizeof(double) == 0, "WarpState pads to doubles");

// torch.clamp_min: a NaN stays NaN
__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }

// Sums over aligned groups of G lanes by a butterfly: every lane of a group
// ends with the same bits (a + b == b + a), so branches on a sum agree.
template <int G>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The lane holding a predicate that exactly one lane holds.
__device__ __forceinline__ int lane_of(bool pred) {
  return __ffs((int)__ballot_sync(FULL, pred)) - 1;
}

// vican_torch/ops/detect.py:_bilinear: nan_to_num, then the clamp to
// [0, W - 1.001] x [0, H - 1.001] (fmax sends a NaN to the low bound, and
// a bound takes +-inf as nan_to_num's +-max does), the four neighbours as
// float64, the weights in the plain version's order.
__device__ __forceinline__ double bilinear(const unsigned char* __restrict__ g, const Params& p,
                                           double x, double y) {
  x = fmin(fmax(x, 0.0), p.xmax);
  y = fmin(fmax(y, 0.0), p.ymax);
  const double x0 = floor(x), y0 = floor(y);
  const double fx = x - x0, fy = y - y0;
  const int W = p.W;
  const unsigned char* px = g + (long long)y0 * W + (long long)x0;
  const double v00 = (double)px[0], v01 = (double)px[1];
  const double v10 = (double)px[W], v11 = (double)px[W + 1];
  return v00 * (1.0 - fx) * (1.0 - fy) + v01 * fx * (1.0 - fy) + v10 * (1.0 - fx) * fy +
         v11 * fx * fy;
}

// refine_corners (AprilTag edge fits) of the slot's quad qs into st->ref.
// scr holds each (edge, sample)'s summed weight and centroid; a lane reads
// back only what it wrote.
__device__ void refine_apriltag(const unsigned char* __restrict__ g, const Params& p,
                                const float* __restrict__ qs, const double* __restrict__ tab,
                                WarpState* st, double* scr, int lane) {
  const int S = p.S, e = lane >> 3, sub = lane & 7, e1 = (e + 1) & 3;
  const double* ts = tab;
  const double* offs = tab + S;
  double* ssw = scr + e * S;
  double* scx = scr + (4 + e) * S;
  double* scy = scr + (8 + e) * S;
  const double ax = qs[2 * e], ay = qs[2 * e + 1], ex = qs[2 * e1], ey = qs[2 * e1 + 1];
  const double dx = ex - ax, dy = ey - ay;
  const double len = clamp_min(sqrt(dx * dx + dy * dy), 1e-6);
  const double nx = -dy / len, ny = dx / len;
  double tot = 0.0;
  for (int s = sub; s < S; s += 8) {
    const double bx = ax + ts[s] * dx, by = ay + ts[s] * dy;
    double sw = 0.0, cx = 0.0, cy = 0.0;
    for (int o = 0; o < p.O; ++o) {
      const double px = bx + offs[o] * nx, py = by + offs[o] * ny;
      const double gp = bilinear(g, p, px + PROBE_STEP * nx, py + PROBE_STEP * ny);
      const double gm = bilinear(g, p, px - PROBE_STEP * nx, py - PROBE_STEP * ny);
      const double w = fabs(gp - gm);
      sw += w;
      cx += w * px;
      cy += w * py;
    }
    const double wsum = clamp_min(sw, 1e-6);
    ssw[s] = sw;
    scx[s] = cx / wsum;
    scy[s] = cy / wsum;
    tot += sw;
  }
  tot = group_sum<8>(tot);
  const double den = clamp_min(tot, 1e-6);
  double mx = 0.0, my = 0.0;
  for (int s = sub; s < S; s += 8) {
    const double wn = ssw[s] / den;
    mx += wn * scx[s];
    my += wn * scy[s];
  }
  mx = group_sum<8>(mx);
  my = group_sum<8>(my);
  double a = 0.0, b = 0.0, c = 0.0;
  for (int s = sub; s < S; s += 8) {
    const double wn = ssw[s] / den, dcx = scx[s] - mx, dcy = scy[s] - my;
    a += wn * dcx * dcx;
    b += wn * dcx * dcy;
    c += wn * dcy * dcy;
  }
  a = group_sum<8>(a);
  b = group_sum<8>(b);
  c = group_sum<8>(c);
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
  double nrx, nry, mnx, mny;  // the edge's fitted line
  if (tot > 1e-3 * S) {
    nrx = -diry;
    nry = dirx;
    mnx = mx;
    mny = my;
  } else {  // washed-out gradients: the coarse edge
    nrx = -dy / len;
    nry = dx / len;
    mnx = (ax + ex) * 0.5;
    mny = (ay + ey) * 0.5;
  }
  // corner k = lane & 3: edges k - 1 and k
  const int k = lane & 3, km = (k + 3) & 3;
  const double n1x = __shfl_sync(FULL, nrx, 8 * km), n1y = __shfl_sync(FULL, nry, 8 * km);
  const double m1x = __shfl_sync(FULL, mnx, 8 * km), m1y = __shfl_sync(FULL, mny, 8 * km);
  const double n2x = __shfl_sync(FULL, nrx, 8 * k), n2y = __shfl_sync(FULL, nry, 8 * k);
  const double m2x = __shfl_sync(FULL, mnx, 8 * k), m2y = __shfl_sync(FULL, mny, 8 * k);
  const double r1 = n1x * m1x + n1y * m1y;
  const double r2 = n2x * m2x + n2y * m2y;
  const double det = n1x * n2y - n1y * n2x;
  const double a00 = n1x + 1e-12, a01 = n1y, a10 = n2x, a11 = n2y + 1e-12;
  const double det_r = a00 * a11 - a01 * a10;
  const double qx = qs[2 * k], qy = qs[2 * k + 1];
  double rx = qx, ry = qy;
  if (fabs(det) > 1e-6) {
    rx = (r1 * a11 - a01 * r2) / det_r;
    ry = (a00 * r2 - a10 * r1) / det_r;
  }
  const double ddx = rx - qx, ddy = ry - qy;
  const bool keep = sqrt(ddx * ddx + ddy * ddy) < p.clamp_px;
  if (lane < 4) {
    st->ref[k][0] = keep ? rx : qx;
    st->ref[k][1] = keep ? ry : qy;
  }
}

// refine_corners_subpix of the slot's quad qs into st->ref.  A trip spreads
// the corners still moving over the warp, G = 32, 16 or 8 lanes a corner
// for 1, 2 or 3-4 of them (a lane every G-th pixel of its corner's window,
// the five sums over the corner's lanes), so the trips of a corner left
// moving alone, the chain's tail, take a quarter of the lanes' steps.
__device__ void refine_subpix(const unsigned char* __restrict__ g, const Params& p,
                              const float* __restrict__ qs, const double* __restrict__ wtab,
                              WarpState* st, int lane) {
  const int side = 2 * p.win + 1, P = side * side;
  if (lane < 4) {
    st->cur[lane][0] = qs[2 * lane];
    st->cur[lane][1] = qs[2 * lane + 1];
    st->move[lane] = INFINITY;
  }
  __syncwarp();
  for (int it = 0; it < p.iters; ++it) {
    int active = 0;  // the same on every lane
#pragma unroll
    for (int c = 0; c < 4; ++c) active |= (st->move[c] >= p.subpix_acc) << c;
    if (!active) break;
    const int na = __popc(active), G = na == 1 ? 32 : (na == 2 ? 16 : 8);
    const int grp = lane / G, sub = lane % G;
    int k = 0;  // the corner of lane group grp: the grp-th active one
    for (int c = 0, seen = 0; c < 4; ++c)
      if (active >> c & 1) {
        if (seen == grp) k = c;
        ++seen;
      }
    const bool on = grp < na;
    const double cx = st->cur[k][0], cy = st->cur[k][1];
    double m0 = 0.0, m1 = 0.0, m2 = 0.0, m3 = 0.0, m4 = 0.0;
    for (int idx = on ? sub : P; idx < P; idx += G) {
      const double px = cx + (double)(idx % side - p.win);
      const double py = cy + (double)(idx / side - p.win);
      const double gx = (bilinear(g, p, px + 1.0, py) - bilinear(g, p, px - 1.0, py)) * 0.5;
      const double gy = (bilinear(g, p, px, py + 1.0) - bilinear(g, p, px, py - 1.0)) * 0.5;
      const double w = wtab[idx];
      m0 += w * gx * gx;
      m1 += w * gx * gy;
      m2 += w * gy * gy;
      m3 += w * (gx * gx * px + gx * gy * py);
      m4 += w * (gx * gy * px + gy * gy * py);
    }
    for (int o = G / 2; o > 0; o >>= 1) {  // a butterfly over the corner's lanes
      m0 += __shfl_xor_sync(FULL, m0, o);
      m1 += __shfl_xor_sync(FULL, m1, o);
      m2 += __shfl_xor_sync(FULL, m2, o);
      m3 += __shfl_xor_sync(FULL, m3, o);
      m4 += __shfl_xor_sync(FULL, m4, o);
    }
    if (on && sub == 0) {
      const double gxx = m0, gxy = m1, gyy = m2, bx = m3, by = m4;
      const double det = gxx * gyy - gxy * gxy;
      const double den = det == 0.0 ? 1.0 : det;
      double nx = cx, ny = cy;
      if (fabs(det) > 1e-9) {
        nx = (gyy * bx - gxy * by) / den;
        ny = (-gxy * bx + gxx * by) / den;
      }
      const double sx = nx - cx, sy = ny - cy;
      st->cur[k][0] = nx;
      st->cur[k][1] = ny;
      st->move[k] = sqrt(sx * sx + sy * sy);
    }
    __syncwarp();
  }
  if (lane < 4) {
    const double qx = qs[2 * lane], qy = qs[2 * lane + 1];
    const double cx = st->cur[lane][0], cy = st->cur[lane][1];
    const double dx = cx - qx, dy = cy - qy;
    const bool keep = sqrt(dx * dx + dy * dy) < p.clamp_px;
    st->ref[lane][0] = keep ? cx : qx;
    st->ref[lane][1] = keep ? cy : qy;
  }
}

// ops/pnp.py:homography_4pt from the marker grid's corners (0, 0), (c, 0),
// (c, c), (0, c) to st->ref into st->Hm: the 8x8 DLT system in its row
// order, solved by LU with partial pivoting (the first largest pivot).
// Lane i < 8 holds row i of the system; pos is the row's place after the
// swaps, so a swap relabels two lanes and moves no data.
__device__ void homography(WarpState* st, double cn, int lane) {
  const int i = (lane >> 1) & 3;
  const double x = (i == 1 || i == 2) ? cn : 0.0, y = i >= 2 ? cn : 0.0;
  const double u = st->ref[i][0], v = st->ref[i][1];
  const bool row = lane < 8, odd = lane & 1;
  double A[8], r;
  A[0] = row && !odd ? x : 0.0;
  A[1] = row && !odd ? y : 0.0;
  A[2] = row && !odd ? 1.0 : 0.0;
  A[3] = row && odd ? x : 0.0;
  A[4] = row && odd ? y : 0.0;
  A[5] = row && odd ? 1.0 : 0.0;
  A[6] = row ? (odd ? -v * x : -u * x) : 0.0;
  A[7] = row ? (odd ? -v * y : -u * y) : 0.0;
  r = row ? (odd ? v : u) : 0.0;
  int pos = lane;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // the pivot: the first row from k on of the largest |A[.][k]|, as the
    // one-thread scan `if (|A[i][k]| > |A[piv][k]|) piv = i` finds it (a
    // NaN at row k keeps it, so it ranks first; a NaN below is never taken),
    // by a lexicographic (|A[.][k]|, -row) tree over lanes 0-7
    const double a = fabs(A[k]);
    double key = pos < k || pos >= 8 ? -2.0 : (isnan(a) ? (pos == k ? INFINITY : -1.0) : a);
    int kp = pos;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      const double ok = __shfl_xor_sync(FULL, key, o);
      const int op = __shfl_xor_sync(FULL, kp, o);
      if (ok > key || (ok == key && op < kp)) {
        key = ok;
        kp = op;
      }
    }
    const int piv = __shfl_sync(FULL, kp, 0);
    if (pos == k)
      pos = piv;
    else if (pos == piv)
      pos = k;
    const int pl = lane_of(pos == k);
    const double f = A[k] / __shfl_sync(FULL, A[k], pl);
    const bool below = pos > k && pos < 8;
#pragma unroll
    for (int j = k + 1; j < 8; ++j) {
      const double akj = __shfl_sync(FULL, A[j], pl);
      if (below) A[j] -= f * akj;
    }
    const double rk = __shfl_sync(FULL, r, pl);
    if (below) r -= f * rk;
  }
  double h[8];
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    double acc = r;
#pragma unroll
    for (int j = k + 1; j < 8; ++j) acc -= A[j] * h[j];
    h[k] = __shfl_sync(FULL, acc / A[k], lane_of(pos == k));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) st->Hm[k] = h[k];
    st->Hm[8] = 1.0;
  }
  __syncwarp();
}

// One sampling pass of decode_quads (_decode_attempt and its gates) with
// the cell positions lin: returns whether the slot decodes and sets best
// (the first index of the least Hamming distance in codes).  samp holds
// the samples, cell by cell, each cell's rows of Sd.
__device__ bool decode_attempt(const unsigned char* __restrict__ g, const Params& p,
                               const double* __restrict__ lin,
                               const long long* __restrict__ codes, WarpState* st,
                               double* samp, int lane, int& best) {
  const int cells = p.n_bits + 2, cells2 = cells * cells, per = p.Sd * p.Sd;
  const int n = cells2 * per;
  __syncwarp();  // the last attempt's reads of samp are done
  const double* H = st->Hm;
  double lo = INFINITY, hi = -INFINITY;
  for (int k0 = 0; k0 < per; k0 += 32) {
    const int k = k0 + lane;
    const bool has = k < per;
    const double du = lin[has ? k % p.Sd : 0], dv = lin[has ? k / p.Sd : 0];
    int c = 0;
    double rd = 0.0, cd = 0.0;  // the cell's row and column
    for (int cell = 0; cell < cells2; ++cell) {
      if (has) {
        const double u = cd + du, v = rd + dv;
        const double pz = H[6] * u + H[7] * v + H[8];
        const double x = (H[0] * u + H[1] * v + H[2]) / pz;
        const double y = (H[3] * u + H[4] * v + H[5]) / pz;
        const double s = bilinear(g, p, x, y);
        samp[cell * per + k] = s;
        lo = fmin(lo, s);
        hi = fmax(hi, s);
      }
      cd += 1.0;
      if (++c == cells) {
        c = 0;
        cd = 0.0;
        rd += 1.0;
      }
    }
  }
  __syncwarp();
  lo = warp_min(lo);
  hi = warp_max(hi);
  const double span = clamp_min(hi - lo, 1e-6);
  // the histogram, 32 samples a round, a sample a lane: ballots of each bit
  // of every lane's bin let lane l count the lanes whose bin is 2 l or
  // 2 l + 1, with no memory and no two lanes updating one count; the bins
  // are computed first, a lane its own, their divisions in flight together
  unsigned char* bins = reinterpret_cast<unsigned char*>(samp + n);
#pragma unroll 4
  for (int i = lane; i < n; i += 32) {
    const int b = (int)((samp[i] - lo) / span * BINS);
    bins[i] = (unsigned char)(b < 0 ? 0 : (b > BINS - 1 ? BINS - 1 : b));
  }
  int c0 = 0, c1 = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const int b = i < n ? bins[i] : 0;
    unsigned same = __ballot_sync(FULL, i < n);  // lanes agreeing with 2 lane past bit 0
#pragma unroll
    for (int bit = 1; bit < 6; ++bit) {
      const unsigned ones = __ballot_sync(FULL, b >> bit & 1);
      same &= (lane >> (bit - 1) & 1) ? ones : ~ones;
    }
    const unsigned odd = __ballot_sync(FULL, b & 1);
    c0 += __popc(same & ~odd);
    c1 += __popc(same & odd);
  }
  // _otsu over bins 2 lane and 2 lane + 1: w0 and s0 are inclusive prefix
  // sums in bin order (w0 exact), then the first argmax of the variance
  const double step = span / BINS;
  const double p0 = (double)c0 * (lo + ((double)(2 * lane) + 0.5) * step);
  const double p1 = (double)c1 * (lo + ((double)(2 * lane + 1) + 0.5) * step);
  int w_in = c0 + c1;
  double s_in = p0 + p1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int wu = __shfl_up_sync(FULL, w_in, o);
    const double su = __shfl_up_sync(FULL, s_in, o);
    if (lane >= o) {
      w_in += wu;
      s_in = su + s_in;
    }
  }
  int w_ex = __shfl_up_sync(FULL, w_in, 1);
  double s_ex = __shfl_up_sync(FULL, s_in, 1);
  if (lane == 0) {
    w_ex = 0;
    s_ex = 0.0;
  }
  const double w0a = (double)(w_ex + c0), w0b = (double)(w_ex + c0 + c1);
  const double s0a = s_ex + p0, s0b = s0a + p1;
  const double s_all = __shfl_sync(FULL, s0b, 31), w_all = (double)n;
  double va, vb;
  {
    const double w1 = w_all - w0a;
    const double d = s0a / clamp_min(w0a, 1e-6) - (s_all - s0a) / clamp_min(w1, 1e-6);
    va = w0a * w1 * (d * d);
  }
  {
    const double w1 = w_all - w0b;
    const double d = s0b / clamp_min(w0b, 1e-6) - (s_all - s0b) / clamp_min(w1, 1e-6);
    vb = w0b * w1 * (d * d);
  }
  double bv = va;
  int bk = 2 * lane;
  if (vb > bv) {
    bv = vb;
    bk = 2 * lane + 1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double ov = __shfl_xor_sync(FULL, bv, o);
    const int ok = __shfl_xor_sync(FULL, bk, o);
    if (ov > bv || (ov == bv && ok < bk)) {
      bv = ov;
      bk = ok;
    }
  }
  const double tau = lo + ((double)bk + 1.0) * step;
  // a cell a lane: its mean and majority bit; the border errors, the word
  // and the means' span over the warp
  int errs = 0;
  long long word = 0;
  double mx = -INFINITY, mn = INFINITY;
  for (int c00 = 0; c00 < cells2; c00 += 32) {
    const int cell = c00 + lane;
    bool border_bit = false;
    if (cell < cells2) {
      const double* sc = samp + cell * per;
      double m = 0.0;
      int above = 0;
      for (int k = 0; k < per; ++k) {
        m += sc[k];
        above += sc[k] > tau;
      }
      const double mean = m / per;
      mx = fmax(mx, mean);
      mn = fmin(mn, mean);
      const bool bit = 2 * above > per;
      const int r = cell / cells, c = cell % cells;
      const bool border = r == 0 || c == 0 || r == cells - 1 || c == cells - 1;
      border_bit = border && bit;
      if (!border && bit) word |= 1LL << ((r - 1) * p.n_bits + (c - 1));
    }
    errs += __popc(__ballot_sync(FULL, border_bit));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) word |= __shfl_xor_sync(FULL, word, o);
  mx = warp_max(mx);
  mn = warp_min(mn);
  const bool gates = errs <= p.max_border_errs && (mx - mn) > p.min_cell_contrast;
  // the dictionary, a lane every 32nd code, 8 loads in flight a round; once
  // a lane holds distance 0 after a round, the first code at distance 0 is
  // among those seen, so the rest cannot change the first least
  int bd = 1 << 30, bj = 0;
  for (int j0 = 0; j0 < p.ncodes; j0 += 256) {
    long long cw[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + 32 * u + lane;
      cw[u] = j < p.ncodes ? codes[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + 32 * u + lane;
      const int d = __popcll((unsigned long long)(word ^ cw[u]));
      if (j < p.ncodes && d < bd) {
        bd = d;
        bj = j;
      }
    }
    if (__any_sync(FULL, bd == 0)) break;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int od = __shfl_xor_sync(FULL, bd, o);
    const int oj = __shfl_xor_sync(FULL, bj, o);
    if (od < bd || (od == bd && oj < bj)) {
      bd = od;
      bj = oj;
    }
  }
  best = bj;
  return gates && bd <= p.ec_bits;
}

// At most 64 registers a thread: 32 warps an SM.
__global__ void __launch_bounds__(SLOT_WARPS * 32)
    detect_slots_kernel(const unsigned char* __restrict__ gray, const float* __restrict__ quads,
                        const unsigned char* __restrict__ valid,
                        const long long* __restrict__ codes, const double* __restrict__ tab,
                        double* __restrict__ slot_corners, long long* __restrict__ slot_ids,
                        unsigned char* __restrict__ slot_ok, Params p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long slot = (long long)blockIdx.x * SLOT_WARPS + warp;
  if (slot >= p.slots || !valid[slot]) return;
  double* region = detect_smem + (long long)warp * p.warp_doubles;
  WarpState* st = reinterpret_cast<WarpState*>(region);
  double* scr = region + STATE_DOUBLES;
  const unsigned char* g = gray + (slot / p.Q) * (long long)p.H * p.W;
  const float* qs = quads + slot * 8;
  if (p.refine == REFINE_APRILTAG)
    refine_apriltag(g, p, qs, tab, st, scr, lane);
  else if (p.refine == REFINE_SUBPIX)
    refine_subpix(g, p, qs, tab + p.S + p.O, st, lane);
  else if (lane < 8)
    st->ref[lane >> 1][lane & 1] = (double)qs[lane];
  __syncwarp();
  homography(st, (double)(p.n_bits + 2), lane);
  const int P = (2 * p.win + 1) * (2 * p.win + 1);
  const double* lin = tab + p.S + p.O + P;
  int best;
  bool ok = decode_attempt(g, p, lin, codes, st, scr, lane, best);
  if (!ok)  // the central half of each cell (vican_tpu/ops/detect.py:958-962)
    ok = decode_attempt(g, p, lin + p.Sd, codes, st, scr, lane, best);
  if (lane < 8) {  // corner k is refined corner (k + rotation) % 4
    const int k = lane >> 1, src = (k + best % 4) & 3;
    slot_corners[slot * 8 + lane] = st->ref[src][lane & 1];
  }
  if (lane == 0) {
    slot_ids[slot] = best / 4;
    slot_ok[slot] = ok;
  }
}

// dedup_and_compact of one frame's Q slots into its D outputs: a warp a
// slot i, its lanes over the slots j.
__global__ void __launch_bounds__(FRAME_THREADS, 1)
    dedup_kernel(const unsigned char* __restrict__ valid, const float* __restrict__ areas,
                 const double* __restrict__ slot_corners,
                 const long long* __restrict__ slot_ids,
                 const unsigned char* __restrict__ slot_ok, double* __restrict__ corners,
                 long long* __restrict__ ids, unsigned char* __restrict__ keep_out,
                 float* __restrict__ score, int Q, int D, float rate) {
  double* cx = detect_smem;
  double* cy = cx + Q;
  float* area = reinterpret_cast<float*>(cy + Q);
  float* edge = area + Q;
  unsigned char* ok = reinterpret_cast<unsigned char*>(edge + Q);
  unsigned char* keep = ok + Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int WARPS = FRAME_THREADS / 32;
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
  for (int i = warp; i < Q; i += WARPS) {
    bool suppressed = false;
    for (int j0 = 0; ok[i] && j0 < Q && !suppressed; j0 += 32) {
      const int j = j0 + lane;
      bool hit = false;
      if (j < Q && ok[j]) {
        const float r = rate * fminf(edge[i], edge[j]);
        const double dx = cx[i] - cx[j], dy = cy[i] - cy[j];
        const bool close = dx * dx + dy * dy < (double)(r * r);
        hit = close && (area[j] > area[i] || (area[j] == area[i] && j < i));
      }
      suppressed = __any_sync(FULL, hit);
    }
    if (lane == 0) keep[i] = ok[i] && !suppressed;
  }
  __syncthreads();
  for (int i = warp; i < Q; i += WARPS) {
    // the slot's place in the stable ascending order of (kept ? -area : inf)
    const bool ki = keep[i];
    const float ai = area[i];
    int rank = 0;
    for (int j0 = 0; j0 < Q; j0 += 32) {
      const int j = j0 + lane;
      bool before = false;
      if (j < Q)
        before = ki ? keep[j] && (area[j] > ai || (area[j] == ai && j < i)) : keep[j] || j < i;
      rank += __popc(__ballot_sync(FULL, before));
    }
    if (rank >= D) continue;
    const long long o = (long long)blockIdx.x * D + rank;
    const bool v = valid[base + i];
    if (lane < 8) corners[o * 8 + lane] = v ? slot_corners[(base + i) * 8 + lane] : 0.0;
    if (lane == 0) {
      ids[o] = v ? slot_ids[base + i] : 0;
      keep_out[o] = ki;
      score[o] = ai;
    }
  }
}

// The launches' shapes from the C entry's arguments, or false for sizes
// past the shared arrays or a 62-bit code.
struct Plan {
  Params p;
  unsigned slot_blocks;
  size_t slot_smem, frame_smem;
};

__host__ bool plan_launches(int B, int H, int W, int Q, int D, int refine, int S, int O,
                            int win, int iters, int n_bits, int Sd, int max_border_errs,
                            int ec_bits, int ncodes, double subpix_acc, double clamp_px,
                            double min_cell_contrast, Plan* out) {
  const int cells2 = (n_bits + 2) * (n_bits + 2);
  if (B <= 0 || Q <= 0 || D <= 0 || D > Q || H < 2 || W < 2 || n_bits < 1 ||
      cells2 > MAX_CELLS2 || S < 1 || S > MAX_SAMPLES || O < 1 || win < 1 || iters < 0 ||
      Sd < 1 || n_bits * n_bits > 62 || ncodes < 1 || refine < REFINE_NONE ||
      refine > REFINE_SUBPIX || (long long)B * Q > 0x7fffffff)
    return false;
  const int n = cells2 * Sd * Sd;  // a decode attempt's samples, then their bins
  int scratch = n + (n + 7) / 8;
  if (refine == REFINE_APRILTAG && 12 * S > scratch) scratch = 12 * S;
  const int warp_doubles = STATE_DOUBLES + scratch;
  out->p = Params{B * Q, H, W, Q, refine, S, O, win, iters, n_bits, Sd, max_border_errs,
                  ec_bits, ncodes, warp_doubles, subpix_acc, clamp_px, min_cell_contrast,
                  (double)W - 1.001, (double)H - 1.001};
  out->slot_blocks = (unsigned)((B * Q + SLOT_WARPS - 1) / SLOT_WARPS);
  out->slot_smem = (size_t)SLOT_WARPS * warp_doubles * sizeof(double);
  out->frame_smem = (size_t)Q * (2 * sizeof(double) + 2 * sizeof(float) + 2);
  return true;
}

}  // namespace

extern "C" int detect_candidates_f64(
    const void* gray, const void* quads, const void* valid, const void* areas, const void* codes,
    const void* tab, void* slot_corners, void* slot_ids, void* slot_ok, void* corners, void* ids,
    void* keep, void* score, int B, int H, int W, int Q, int D, int refine, int S,
    int O, int win, int iters, int n_bits, int Sd, int max_border_errs, int ec_bits, int ncodes,
    double subpix_acc, double clamp_px, double min_cell_contrast, float dedup_rate,
    void* stream) {
  Plan l;
  if (!plan_launches(B, H, W, Q, D, refine, S, O, win, iters, n_bits, Sd, max_border_errs,
                     ec_bits, ncodes, subpix_acc, clamp_px, min_cell_contrast, &l))
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (l.slot_smem > (size_t)optin || l.frame_smem > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  // past 48 KB a kernel's dynamic shared memory needs the function's opt-in
  const auto smem_attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if (l.slot_smem > 48 * 1024)
    err = cudaFuncSetAttribute(detect_slots_kernel, smem_attr, (int)l.slot_smem);
  if (err == cudaSuccess && l.frame_smem > 48 * 1024)
    err = cudaFuncSetAttribute(dedup_kernel, smem_attr, (int)l.frame_smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const unsigned char*>(valid);
  auto* sc = static_cast<double*>(slot_corners);
  auto* si = static_cast<long long*>(slot_ids);
  auto* so = static_cast<unsigned char*>(slot_ok);
  detect_slots_kernel<<<l.slot_blocks, SLOT_WARPS * 32, l.slot_smem, s>>>(
      static_cast<const unsigned char*>(gray), static_cast<const float*>(quads), v,
      static_cast<const long long*>(codes), static_cast<const double*>(tab), sc, si, so, l.p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dedup_kernel<<<B, FRAME_THREADS, l.frame_smem, s>>>(
      v, static_cast<const float*>(areas), sc, si, so, static_cast<double*>(corners),
      static_cast<long long*>(ids), static_cast<unsigned char*>(keep),
      static_cast<float*>(score), Q, D, dedup_rate);
  return (int)cudaGetLastError();
}

extern "C" const char* detect_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
