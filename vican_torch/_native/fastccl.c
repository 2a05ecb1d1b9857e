/* fastccl — connected components + quad candidates for marker detection.
 *
 * Labeling is irregular pointer-chasing work that a CPU beats any
 * dense-tensor formulation at; the detection pipeline therefore splits:
 * dense numerics (threshold sweep, subpixel refinement, bit decoding, PnP)
 * on the TPU, component labeling + coarse quad extraction here.
 * Quality-equivalent to OpenCV's contour stage (8-connected, reference
 * cam.py:147's detectMarkers internals).
 *
 * RUN-BASED union-find: foreground pixels are grouped into per-row runs
 * and the union-find operates on runs, not pixels — ~20x fewer unions and
 * no megapixel parent array (the per-pixel variant measured ~16 ms/image
 * across the 7-window sweep at 720p; runs take ~2 ms).  Component stats
 * come from run arithmetic (sum over a run is a closed form), and the
 * farthest-point corner scans evaluate RUN ENDPOINTS only: all three
 * selection metrics (squared distance from a point, and the signed cross
 * product against a line) are convex/linear in x along a run, so their
 * maximum over the run is attained at an endpoint; endpoints are evaluated
 * in (y, x) scan order with strict '>' comparisons, reproducing the
 * pixel-sweep's tie-breaking exactly.
 *
 * SPLIT CANDIDATES (4-connectivity): at extreme oblique viewing angles,
 * adjacent markers' border rings blur into ONE 8-connected component via
 * thin DIAGONAL aliasing strands, and the merged candidate decodes as
 * nothing (the 8 `only_reference` detections of VERDICT r3; OpenCV's
 * CORNER_REFINE_APRILTAG escapes via the AprilTag quad detector, whose
 * union-find is 4-connected).  Since runs are shared, a second union pass
 * with 4-connected overlap ([s, e] instead of [s-1, e+1]) is nearly free;
 * 4-connected components that are STRICT SUBSETS of their 8-connected
 * parent (area4 < area8) are emitted as extra candidates — the dictionary
 * decode is the backstop, so recall improves with zero false-id risk.
 *
 * Exposed as vican_torch._native.fastccl.quad_candidates[_packed/_packed2]()
 * and, for a whole batch, quad_candidates_batch().  A copy of
 * vican_tpu/_native/fastccl.c with the same output, byte for byte, except
 * that every entry point labels with the GIL released (perception's feed
 * thread labels while the calling thread runs detection) and the batch
 * entry points are added.  Validated against the JAX package's module and
 * the scipy fallback in tests/test_torch_fastccl.py.
 *
 * Added here: the candidates' winding, gates and degenerate re-fit
 * (quad_gates.h, included below the labeler and compiled without
 * floating-point contraction), as quad_candidates_gated_batch() (labeler
 * and gates, a batch in one call, its (frame, window) masks spread over
 * the threads the caller names) and gate_candidates_batch() (the gates
 * on given slots, one thread); tests/test_torch_gates.py holds them to
 * the numpy gates.  quad_candidates_gated_batch() also reports, where the
 * caller asks, its threads' time in the labeler and in the gates and the
 * call's own, in ticks of one clock, how many threads ran and how many
 * runs they labeled.
 *
 * The labeler's steps, not its output, differ from the JAX package's
 * copy: a packed row is read 64 bits at a time (a word's run edges by
 * count-trailing-zeros, a word with none passed at one test; a scan a byte
 * at a time spent half the labeler's time, paid per run), and both
 * connectivities are united in one sweep over the rows.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

typedef struct {
    int32_t area;
    int64_t sx, sy; /* centroid accumulators */
} Stats;

static int32_t find_root(int32_t *parent, int32_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]]; /* path halving */
        x = parent[x];
    }
    return x;
}

static void unite(int32_t *parent, int32_t a, int32_t b) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a < b) parent[b] = a;
    else if (b < a) parent[a] = b;
}

/* Union runs between consecutive rows, both connectivities in one sweep:
 * into parent8 the runs overlapping [s-1, e+1] (8-connectivity) and, where
 * parent4 is not NULL, into it those overlapping [s, e] (4-connectivity),
 * a subset of the first.  A component's root is its smallest run index
 * whatever the order of the unions, so the partitions are those of one
 * sweep a connectivity. */
static void link_runs(int32_t *parent8, int32_t *parent4, int32_t nruns, const int32_t *rs,
                      const int32_t *re, const int32_t *row_first, Py_ssize_t H) {
    for (int32_t i = 0; i < nruns; i++) parent8[i] = i;
    if (parent4)
        for (int32_t i = 0; i < nruns; i++) parent4[i] = i;
    for (int32_t y = 1; y < H; y++) {
        int32_t lo = row_first[y], hi = row_first[y + 1];
        int32_t plo = row_first[y - 1], phi = row_first[y];
        int32_t j = plo;
        for (int32_t i = lo; i < hi; i++) {
            const int32_t s = rs[i], e = re[i];
            while (j < phi && re[j] < s - 1) j++;
            for (int32_t k = j; k < phi && rs[k] <= e + 1; k++) {
                unite(parent8, i, k);
                if (parent4 && re[k] >= s && rs[k] <= e) unite(parent4, i, k);
            }
        }
    }
}

/* Flatten parents, assign stat slots (roots keep minimum run index, so a
 * root precedes its children in run order), accumulate run stats. */
static int run_stats(int32_t *parent, int32_t *slot, int32_t nruns,
                     const int32_t *rs, const int32_t *re, const int32_t *ry,
                     Stats **stats_out) {
    int cap = 256, nstats = 0;
    Stats *stats = (Stats *)malloc((size_t)cap * sizeof(Stats));
    if (!stats) return -1;
    for (int32_t i = 0; i < nruns; i++) {
        int32_t r = find_root(parent, i);
        parent[i] = r;
        int32_t s;
        if (r == i) {
            if (nstats == cap) {
                cap *= 2;
                Stats *grown = (Stats *)realloc(stats, (size_t)cap * sizeof(Stats));
                if (!grown) { free(stats); return -1; }
                stats = grown;
            }
            s = nstats++;
            stats[s] = (Stats){0, 0, 0};
        } else {
            s = slot[r];
        }
        slot[i] = s;
        Stats *st = &stats[s];
        int64_t len = re[i] - rs[i] + 1;
        st->area += (int32_t)len;
        st->sx += (int64_t)(rs[i] + re[i]) * len / 2;
        st->sy += (int64_t)ry[i] * len;
    }
    *stats_out = stats;
    return nstats;
}

/* Farthest-point quad corners for the components listed in keep[] (slot ->
 * output index or -1), writing to corners/areas at out_base.  Run lists are
 * compacted in ONE sweep; endpoints evaluated in (y, x) scan order. */
static int corner_pass(const int32_t *slot, int32_t nruns, int nstats,
                       const int32_t *rs, const int32_t *re, const int32_t *ry,
                       const Stats *stats, const int *order, int nkeep,
                       float *corners, int32_t *areas) {
    int32_t *keep = (int32_t *)malloc((size_t)(nstats > 0 ? nstats : 1) * sizeof(int32_t));
    int32_t *runcnt = (int32_t *)calloc((size_t)(nkeep > 0 ? nkeep : 1), sizeof(int32_t));
    if (!keep || !runcnt) { free(keep); free(runcnt); return -1; }
    for (int s = 0; s < nstats; s++) keep[s] = -1;
    int64_t total_runs = 0;
    for (int a = 0; a < nkeep; a++) keep[order[a]] = a;
    for (int32_t i = 0; i < nruns; i++) {
        int32_t a = keep[slot[i]];
        if (a >= 0) { runcnt[a]++; total_runs++; }
    }
    int64_t *off = (int64_t *)malloc(((size_t)nkeep + 1) * sizeof(int64_t));
    int64_t *fill = (int64_t *)malloc(((size_t)nkeep + 1) * sizeof(int64_t));
    int32_t *lst = (int32_t *)malloc((size_t)(total_runs > 0 ? total_runs : 1) * sizeof(int32_t));
    if (!off || !fill || !lst) {
        free(keep); free(runcnt); free(off); free(fill); free(lst);
        return -1;
    }
    off[0] = 0;
    for (int a = 0; a < nkeep; a++) off[a + 1] = off[a] + runcnt[a];
    memcpy(fill, off, ((size_t)nkeep + 1) * sizeof(int64_t));
    for (int32_t i = 0; i < nruns; i++) {
        int32_t a = keep[slot[i]];
        if (a >= 0) lst[fill[a]++] = i; /* run-index order == (y, x) order */
    }

    for (int a = 0; a < nkeep; a++) {
        const Stats *st = &stats[order[a]];
        const int32_t *runs = lst + off[a];
        const int64_t nr = off[a + 1] - off[a];
        double cx = (double)st->sx / st->area;
        double cy = (double)st->sy / st->area;
        double p1x = cx, p1y = cy, best = -1.0;
        for (int64_t q = 0; q < nr; q++) {
            int32_t i = runs[q];
            double y = ry[i];
            double xs2[2] = {(double)rs[i], (double)re[i]};
            for (int u = 0; u < 2; u++) {
                double d = (xs2[u] - cx) * (xs2[u] - cx) + (y - cy) * (y - cy);
                if (d > best) { best = d; p1x = xs2[u]; p1y = y; }
            }
        }
        double p2x = p1x, p2y = p1y;
        best = -1.0;
        for (int64_t q = 0; q < nr; q++) {
            int32_t i = runs[q];
            double y = ry[i];
            double xs2[2] = {(double)rs[i], (double)re[i]};
            for (int u = 0; u < 2; u++) {
                double d = (xs2[u] - p1x) * (xs2[u] - p1x) + (y - p1y) * (y - p1y);
                if (d > best) { best = d; p2x = xs2[u]; p2y = y; }
            }
        }
        double dx = p2x - p1x, dy = p2y - p1y;
        double p3x = p1x, p3y = p1y, p4x = p2x, p4y = p2y;
        double bmax = -1e30, bmin = 1e30;
        for (int64_t q = 0; q < nr; q++) {
            int32_t i = runs[q];
            double y = ry[i];
            double xs2[2] = {(double)rs[i], (double)re[i]};
            for (int u = 0; u < 2; u++) {
                double c = (xs2[u] - p1x) * dy - (y - p1y) * dx;
                if (c > bmax) { bmax = c; p3x = xs2[u]; p3y = y; }
                if (c < bmin) { bmin = c; p4x = xs2[u]; p4y = y; }
            }
        }
        float *qq = corners + (size_t)a * 8;
        qq[0] = (float)p1x; qq[1] = (float)p1y;
        qq[2] = (float)p3x; qq[3] = (float)p3y;
        qq[4] = (float)p2x; qq[5] = (float)p2y;
        qq[6] = (float)p4x; qq[7] = (float)p4y;
        areas[a] = st->area;
    }
    free(keep); free(runcnt); free(off); free(fill); free(lst);
    return 0;
}

/* Selection-sort the top-K of order[0..n) by area (strict '>' keeps the
 * original order on ties — slot creation order == scan order). */
static int top_k(int *order, int n, Py_ssize_t K, const Stats *stats) {
    if (n > K) {
        for (int a = 0; a < K; a++) {
            int best = a;
            for (int b = a + 1; b < n; b++)
                if (stats[order[b]].area > stats[order[best]].area) best = b;
            int tmp = order[a]; order[a] = order[best]; order[best] = tmp;
        }
        n = (int)K;
    }
    return n;
}

/* The labeler on one mask: ``im`` is a contiguous (H, Wb) bit-packed mask
 * (Wb > 0; bit x of a row at row[x >> 3] >> (x & 7), np.packbits
 * bitorder="little", the layout fastthresh.c and the device threshold emit,
 * so the ~8x-larger unpacked mask is never materialized on the host) or,
 * with Wb == 0, an (H, W) byte mask (nonzero = foreground).  Writes K + K2
 * corner slots (float32 (4, 2) each) and area slots, zeroed first, and the
 * counts of 8-connected candidates (slots [0, K)) and of 4-connected SPLIT
 * candidates (slots [K, K+K2), see the module docstring), and where
 * nruns_out is not NULL the number of runs it labeled.  Returns 0, or -1
 * when out of memory.  It touches no Python object, so its callers run it
 * with the GIL released. */
static int qc_core(const uint8_t *im, Py_ssize_t H, Py_ssize_t W, Py_ssize_t Wb,
                   Py_ssize_t K, Py_ssize_t K2, double min_area, double max_area,
                   float *corners, int32_t *areas, int *n8_out, int *n4_out,
                   int32_t *nruns_out) {
    const int packed = Wb > 0;
    const Py_ssize_t stride = packed ? Wb : W;
    int rc = -1;
    memset(corners, 0, (size_t)(K + K2) * 8 * sizeof(float));
    memset(areas, 0, (size_t)(K + K2) * sizeof(int32_t));
    *n8_out = *n4_out = 0;

    /* ---- extract runs per row ---- */
    int32_t rcap = 4096, nruns = 0;
    const int32_t row_runs = (int32_t)((W + 1) / 2); /* the most runs a row holds */
    int32_t *rs = (int32_t *)malloc((size_t)rcap * sizeof(int32_t)); /* start x */
    int32_t *re = (int32_t *)malloc((size_t)rcap * sizeof(int32_t)); /* end x (incl) */
    int32_t *ry = (int32_t *)malloc((size_t)rcap * sizeof(int32_t)); /* row */
    int32_t *row_first = (int32_t *)malloc(((size_t)H + 1) * sizeof(int32_t));
    /* a packed row's edges: x of each bit that differs from the bit left of
     * it (a run's start, or one past its end) */
    int32_t *edge = packed ? (int32_t *)malloc(((size_t)W + 2) * sizeof(int32_t)) : NULL;
    int32_t *parent8 = NULL, *slot8 = NULL, *parent4 = NULL;
    Stats *stats8 = NULL;
    int *order = NULL;
    int nstats8, nkeep8 = 0, nkeep4 = 0;
    if (!rs || !re || !ry || !row_first || (packed && !edge)) goto done;
    /* the packed rows in 64-bit words: the words that cover [0, W), of
     * which the first `full` lie whole inside the row's Wb bytes; the last
     * word's bits from W on are masked off, so a run open at W ends there */
    const int32_t nw = (int32_t)((W + 63) >> 6);
    const int32_t full = (int32_t)(Wb >> 3) < nw ? (int32_t)(Wb >> 3) : nw;
    const uint64_t last_mask = (W & 63) ? ((uint64_t)1 << (W & 63)) - 1 : ~(uint64_t)0;
    for (int32_t y = 0; y < H; y++) {
        row_first[y] = nruns;
        if (nruns + row_runs > rcap) {
            while (nruns + row_runs > rcap) rcap *= 2;
            int32_t *rs2 = (int32_t *)realloc(rs, (size_t)rcap * sizeof(int32_t));
            if (rs2) rs = rs2;
            int32_t *re2 = (int32_t *)realloc(re, (size_t)rcap * sizeof(int32_t));
            if (re2) re = re2;
            int32_t *ry2 = (int32_t *)realloc(ry, (size_t)rcap * sizeof(int32_t));
            if (ry2) ry = ry2;
            if (!rs2 || !re2 || !ry2) goto done;
        }
        const uint8_t *row = im + (size_t)y * stride;
        if (packed) {
            /* a word at a time: its edges are the set bits of w ^ (w << 1
             * | the previous word's top bit), so a word of zeros outside a
             * run, or of ones inside one, costs one test */
            int32_t n = 0;
            uint64_t carry = 0;
            for (int32_t k = 0; k < nw; k++) {
                uint64_t w = 0;
                if (k < full) {
                    memcpy(&w, row + ((size_t)k << 3), 8);
                } else {
                    for (int32_t b = 0; (k << 3) + b < Wb && b < 8; b++)
                        w |= (uint64_t)row[(k << 3) + b] << (b << 3);
                }
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
                if (k < full) w = __builtin_bswap64(w);
#endif
                if (k == nw - 1) w &= last_mask;
                uint64_t t = w ^ (w << 1 | carry);
                carry = w >> 63;
                const int32_t base = k << 6;
                while (t) {
                    edge[n++] = base + __builtin_ctzll(t);
                    t &= t - 1;
                }
            }
            if (n & 1) edge[n++] = (int32_t)W; /* a run open at the row's end */
            for (int32_t q = 0; q < n; q += 2) {
                rs[nruns] = edge[q]; re[nruns] = edge[q + 1] - 1; ry[nruns] = y;
                nruns++;
            }
        } else {
            int32_t x = 0;
            while (x < W) {
                int32_t s, e;
                while (x < W && !row[x]) x++;
                if (x >= W) break;
                s = x;
                while (x < W && row[x]) x++;
                e = x - 1;
                rs[nruns] = s; re[nruns] = e; ry[nruns] = y;
                nruns++;
            }
        }
    }
    row_first[H] = nruns;
    if (nruns_out) *nruns_out = nruns;

    /* ---- components of both connectivities, one sweep ---- */
    parent8 = (int32_t *)malloc((size_t)(nruns > 0 ? nruns : 1) * sizeof(int32_t));
    slot8 = (int32_t *)malloc((size_t)(nruns > 0 ? nruns : 1) * sizeof(int32_t));
    if (!parent8 || !slot8) goto done;
    if (K2 > 0 && nruns > 0) {
        parent4 = (int32_t *)malloc((size_t)nruns * sizeof(int32_t));
        if (!parent4) goto done;
    }
    link_runs(parent8, parent4, nruns, rs, re, row_first, H);

    /* ---- 8-connected components ---- */
    nstats8 = run_stats(parent8, slot8, nruns, rs, re, ry, &stats8);
    if (nstats8 < 0) goto done;

    order = (int *)malloc((size_t)(nstats8 > 0 ? nstats8 : 1) * sizeof(int));
    if (!order) goto done;
    for (int s = 0; s < nstats8; s++)
        if (stats8[s].area >= (int32_t)min_area && stats8[s].area <= (int32_t)max_area)
            order[nkeep8++] = s;
    nkeep8 = top_k(order, nkeep8, K, stats8);
    if (corner_pass(slot8, nruns, nstats8, rs, re, ry, stats8, order, nkeep8,
                    corners, areas))
        goto done;

    /* ---- 4-connected SPLIT candidates ---- */
    if (parent4) {
        int32_t *slot4 = (int32_t *)malloc((size_t)nruns * sizeof(int32_t));
        Stats *stats4 = NULL;
        int32_t *root_run4 = NULL;
        int *order4 = NULL;
        int nstats4 = -1;
        if (slot4) nstats4 = run_stats(parent4, slot4, nruns, rs, re, ry, &stats4);
        if (nstats4 >= 0) {
            root_run4 = (int32_t *)malloc((size_t)(nstats4 > 0 ? nstats4 : 1) * sizeof(int32_t));
            order4 = (int *)malloc((size_t)(nstats4 > 0 ? nstats4 : 1) * sizeof(int));
        }
        int ok4 = root_run4 && order4;
        if (ok4) {
            /* area of the 8-conn parent of each 4-conn component: the
             * 4-conn root run belongs to exactly one 8-conn component */
            for (int32_t i = nruns - 1; i >= 0; i--) root_run4[slot4[i]] = i;
            for (int s = 0; s < nstats4; s++) {
                int32_t a4 = stats4[s].area;
                if (a4 < (int32_t)min_area || a4 > (int32_t)max_area) continue;
                int32_t a8 = stats8[slot8[root_run4[s]]].area;
                if (a4 >= a8) continue; /* not a split: same component either way */
                order4[nkeep4++] = s;
            }
            nkeep4 = top_k(order4, nkeep4, K2, stats4);
            ok4 = !corner_pass(slot4, nruns, nstats4, rs, re, ry, stats4, order4, nkeep4,
                               corners + (size_t)K * 8, areas + K);
        }
        free(order4); free(root_run4); free(stats4); free(slot4);
        if (!ok4) goto done;
    }
    *n8_out = nkeep8;
    *n4_out = nkeep4;
    rc = 0;
done:
    free(order); free(stats8); free(slot8); free(parent8); free(parent4);
    free(rs); free(re); free(ry); free(row_first); free(edge);
    return rc;
}

#include "quad_gates.h"

/* quad_candidates(fg_bytes, H, W, K, min_area, max_area)
 *   fg_bytes: contiguous uint8 (H*W), nonzero = foreground
 * quad_candidates_packed(packed_bytes, H, W, Wb, K, min_area, max_area)
 *   packed_bytes: contiguous bit-packed (H, Wb), the layout of qc_core
 * quad_candidates_packed2(packed_bytes, H, W, Wb, K, K2, min_area, max_area)
 *   additionally returns up to K2 4-connected SPLIT candidates in slots
 *   [K, K+K2).
 * All return (corners float32 (K+K2, 4, 2), areas int32 (K+K2,), count8,
 * count4) — the two-argument forms with K2 = 0 return counts (n, 0).
 * The labeling runs with the GIL released.
 */
static PyObject *qc_impl(Py_buffer *fg, Py_ssize_t H, Py_ssize_t W,
                         Py_ssize_t Wb, Py_ssize_t K, Py_ssize_t K2,
                         double min_area, double max_area, int legacy) {
    const Py_ssize_t stride = Wb > 0 ? Wb : W;
    if (fg->len < H * stride) {
        PyBuffer_Release(fg);
        PyErr_SetString(PyExc_ValueError, "fg buffer too small");
        return NULL;
    }
    float *corners = (float *)malloc((size_t)(K + K2) * 8 * sizeof(float) + 1);
    int32_t *areas = (int32_t *)malloc((size_t)(K + K2) * sizeof(int32_t) + 1);
    int rc = -1, nkeep8 = 0, nkeep4 = 0;
    if (corners && areas) {
        Py_BEGIN_ALLOW_THREADS
        rc = qc_core((const uint8_t *)fg->buf, H, W, Wb, K, K2, min_area, max_area,
                     corners, areas, &nkeep8, &nkeep4, NULL);
        Py_END_ALLOW_THREADS
    }
    PyBuffer_Release(fg);
    if (rc) {
        free(corners); free(areas);
        return PyErr_NoMemory();
    }
    PyObject *c_bytes = PyBytes_FromStringAndSize(
        (char *)corners, (Py_ssize_t)(K + K2) * 8 * sizeof(float));
    PyObject *a_bytes = PyBytes_FromStringAndSize(
        (char *)areas, (Py_ssize_t)(K + K2) * sizeof(int32_t));
    free(corners);
    free(areas);
    if (!c_bytes || !a_bytes) {
        Py_XDECREF(c_bytes); Py_XDECREF(a_bytes);
        return NULL;
    }
    if (legacy)
        return Py_BuildValue("(NNi)", c_bytes, a_bytes, nkeep8);
    return Py_BuildValue("(NNii)", c_bytes, a_bytes, nkeep8, nkeep4);
}

static PyObject *quad_candidates(PyObject *self, PyObject *args) {
    Py_buffer fg;
    Py_ssize_t H, W, K;
    double min_area, max_area;
    if (!PyArg_ParseTuple(args, "y*nnndd", &fg, &H, &W, &K, &min_area, &max_area))
        return NULL;
    return qc_impl(&fg, H, W, 0, K, 0, min_area, max_area, 1);
}

static PyObject *quad_candidates_packed(PyObject *self, PyObject *args) {
    Py_buffer fg;
    Py_ssize_t H, W, Wb, K;
    double min_area, max_area;
    if (!PyArg_ParseTuple(args, "y*nnnndd", &fg, &H, &W, &Wb, &K, &min_area, &max_area))
        return NULL;
    if (Wb * 8 < W) {
        PyBuffer_Release(&fg);
        PyErr_SetString(PyExc_ValueError, "Wb too small for W");
        return NULL;
    }
    return qc_impl(&fg, H, W, Wb, K, 0, min_area, max_area, 1);
}

static PyObject *quad_candidates_packed2(PyObject *self, PyObject *args) {
    Py_buffer fg;
    Py_ssize_t H, W, Wb, K, K2;
    double min_area, max_area;
    if (!PyArg_ParseTuple(args, "y*nnnnndd", &fg, &H, &W, &Wb, &K, &K2,
                          &min_area, &max_area))
        return NULL;
    if (Wb * 8 < W) {
        PyBuffer_Release(&fg);
        PyErr_SetString(PyExc_ValueError, "Wb too small for W");
        return NULL;
    }
    return qc_impl(&fg, H, W, Wb, K, K2, min_area, max_area, 0);
}

/* quad_candidates_batch(packed, B, Wn, H, W, Wb, K, K2, min_area, max_area,
 *                       corners_out, areas_out, counts_out)
 *   packed: contiguous bit-packed (B, Wn, H, Wb) masks (the layout of
 *   qc_core); the outputs are writable contiguous buffers that the call
 *   fills: corners float32 (B, Wn*(K+K2), 4, 2), areas int32
 *   (B, Wn*(K+K2)), counts int32 (B, Wn, 2) = (count8, count4).
 * Each (frame, window) is labeled as quad_candidates_packed2 labels it,
 * byte for byte, all in ONE call with the GIL released: a batch of 32
 * frames x 7 windows would otherwise cost 224 calls, each with Python glue
 * that holds the GIL.  Returns None.
 */
static PyObject *quad_candidates_batch(PyObject *self, PyObject *args) {
    Py_buffer fg, c_out, a_out, n_out;
    Py_ssize_t B, Wn, H, W, Wb, K, K2;
    double min_area, max_area;
    if (!PyArg_ParseTuple(args, "y*nnnnnnnddw*w*w*", &fg, &B, &Wn, &H, &W, &Wb, &K,
                          &K2, &min_area, &max_area, &c_out, &a_out, &n_out))
        return NULL;
    const char *err = NULL;
    if (B < 0 || Wn < 0 || H < 0 || W < 0 || K < 0 || K2 < 0 || Wb * 8 < W || Wb <= 0)
        err = "bad shape";
    else if (fg.len < B * Wn * H * Wb)
        err = "packed buffer too small";
    else if (c_out.len < B * Wn * (K + K2) * 8 * (Py_ssize_t)sizeof(float)
             || a_out.len < B * Wn * (K + K2) * (Py_ssize_t)sizeof(int32_t)
             || n_out.len < B * Wn * 2 * (Py_ssize_t)sizeof(int32_t))
        err = "output buffer too small";
    int rc = 0;
    if (!err) {
        const uint8_t *im = (const uint8_t *)fg.buf;
        float *corners = (float *)c_out.buf;
        int32_t *areas = (int32_t *)a_out.buf;
        int32_t *counts = (int32_t *)n_out.buf;
        Py_BEGIN_ALLOW_THREADS
        for (Py_ssize_t m = 0; m < B * Wn && !rc; m++) {
            int n8, n4;
            rc = qc_core(im + (size_t)m * H * Wb, H, W, Wb, K, K2, min_area, max_area,
                         corners + (size_t)m * (K + K2) * 8,
                         areas + (size_t)m * (K + K2), &n8, &n4, NULL);
            counts[2 * m] = n8;
            counts[2 * m + 1] = n4;
        }
        Py_END_ALLOW_THREADS
    }
    PyBuffer_Release(&fg);
    PyBuffer_Release(&c_out);
    PyBuffer_Release(&a_out);
    PyBuffer_Release(&n_out);
    if (err) {
        PyErr_SetString(PyExc_ValueError, err);
        return NULL;
    }
    if (rc) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

/* The checks shared by the two gated entry points: the shape, the packed
 * masks and the output buffers of a (B, Wn, H, Wb) batch of Ks slots a
 * window.  Returns NULL or the error's message. */
static const char *gated_args_error(Py_ssize_t B, Py_ssize_t Wn, Py_ssize_t H, Py_ssize_t W,
                                    Py_ssize_t Wb, Py_ssize_t K, Py_ssize_t K2,
                                    const Py_buffer *fg, const Py_buffer *q,
                                    const Py_buffer *a, const Py_buffer *v,
                                    const Py_buffer *st) {
    const Py_ssize_t slots = B * Wn * (K + K2);
    if (B < 0 || Wn < 0 || H < 0 || W < 0 || K < 0 || K2 < 0 || Wb * 8 < W || Wb <= 0)
        return "bad shape";
    if (fg->len < B * Wn * H * Wb)
        return "packed buffer too small";
    if (q->len < slots * 8 * (Py_ssize_t)sizeof(float)
        || a->len < slots * (Py_ssize_t)sizeof(float) || v->len < slots
        || st->len < GS_N * (Py_ssize_t)sizeof(int64_t))
        return "output buffer too small";
    return NULL;
}

/* The labeler and gates of quad_candidates_gated_batch over the batch's
 * B*Wn (frame, window) masks, shared by its threads: each takes the next
 * mask from `next` and writes only that mask's output rows, so the bytes
 * are the same whatever the thread count and order. */
typedef struct {
    const uint8_t *im;
    Py_ssize_t masks, H, W, Wb, K, K2, next;
    double max_area;
    const GateParams *gp;
    float *quads, *areas;
    uint8_t *valid;
    int failed;
} GatedBatch;

typedef struct {
    GatedBatch *job;
    int64_t stats[GS_N]; /* this thread's re-fit counters */
    uint64_t labeler, gates; /* its ticks in qc_core and gate_window */
    int64_t runs;            /* the runs qc_core labeled */
    int rc;
} GatedWorker;

/* A worker's clock around each mask's two steps, in ticks that the caller
 * turns into seconds by the call's own ticks and its own clock around the
 * call: on x86 the time-stamp counter, elsewhere CLOCK_MONOTONIC in
 * nanoseconds.  Not clock_gettime on x86: that import grows the module's
 * PLT and moves the labeler's code, which cost it ~10% of a 720p batch's
 * wall on one host (in one process, against the module without it); the
 * counter adds no import. */
#if defined(__x86_64__) || defined(__i386__)
#include <x86intrin.h>
static inline uint64_t ticks(void) { return __rdtsc(); }
#else
static inline uint64_t ticks(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (uint64_t)ts.tv_sec * 1000000000u + (uint64_t)ts.tv_nsec;
}
#endif

static void *gated_worker(void *arg) {
    GatedWorker *w = (GatedWorker *)arg;
    GatedBatch *job = w->job;
    const Py_ssize_t Ks = job->K + job->K2;
    int32_t *areas_i = (int32_t *)malloc((size_t)Ks * sizeof(int32_t) + 1);
    w->rc = areas_i ? 0 : -1;
    uint64_t labeler = 0, gates = 0;
    int64_t runs = 0;
    while (!w->rc && !__atomic_load_n(&job->failed, __ATOMIC_RELAXED)) {
        const Py_ssize_t m = __atomic_fetch_add(&job->next, 1, __ATOMIC_RELAXED);
        if (m >= job->masks) break;
        const uint8_t *mask = job->im + (size_t)m * job->H * job->Wb;
        float *quads = job->quads + (size_t)m * Ks * 8;
        int n8, n4;
        int32_t nruns = 0;
        const uint64_t t0 = ticks();
        w->rc = qc_core(mask, job->H, job->W, job->Wb, job->K, job->K2, job->gp->min_area,
                        job->max_area, quads, areas_i, &n8, &n4, &nruns);
        const uint64_t t1 = ticks();
        labeler += t1 - t0;
        runs += nruns;
        if (!w->rc) {
            w->rc = gate_window(mask, job->Wb, job->gp, job->K, Ks, n8, n4, quads, areas_i,
                                job->areas + (size_t)m * Ks, job->valid + (size_t)m * Ks,
                                w->stats);
            gates += ticks() - t1;
        }
    }
    w->labeler = labeler;
    w->gates = gates;
    w->runs = runs;
    if (w->rc) __atomic_store_n(&job->failed, 1, __ATOMIC_RELAXED);
    free(areas_i);
    return NULL;
}

/* quad_candidates_gated_batch(packed, B, Wn, H, W, Wb, K, K2, min_area,
 *                             max_area, border_margin, min_hollow_side,
 *                             quads_out, areas_out, valid_out, stats_out,
 *                             threads[, times_out])
 *   packed: contiguous bit-packed (B, Wn, H, Wb) masks (the layout of
 *   qc_core); the outputs are writable contiguous buffers that the call
 *   fills: quads float32 (B, Wn*(K+K2), 4, 2), areas float32
 *   (B, Wn*(K+K2)), valid bool (B, Wn*(K+K2)), stats int64 (GS_N,), the
 *   re-fit counters of quad_gates.h, and where given times float64 (5,):
 *   the ticks the threads spent in the labeler and in the gates, summed
 *   over them, the number of threads that ran, the ticks from before the
 *   first thread starts to after the last one joins (the caller's clock
 *   around the call, over these, scales the first two), and the runs the
 *   labeler found in the batch's masks.
 * Each (frame, window) is labeled as quad_candidates_batch labels it, then
 * wound, gated and re-fit as vican_torch/perception.py's _gated_candidates
 * does it (quad_gates.h), byte for byte: the whole of perception's host
 * candidates for a batch in ONE call with the GIL released.  The masks
 * are spread over min(threads, B*Wn) threads (the calling one among
 * them), each with its own scratch and counters; the counters are summed
 * in thread order after the join.  A thread that cannot start leaves its
 * share to the others.  Returns None.
 */
static PyObject *quad_candidates_gated_batch(PyObject *self, PyObject *args) {
    Py_buffer fg, q_out, a_out, v_out, s_out, t_out;
    Py_ssize_t B, Wn, H, W, Wb, K, K2, threads;
    GateParams gp;
    double max_area;
    memset(&t_out, 0, sizeof(t_out));
    if (!PyArg_ParseTuple(args, "y*nnnnnnnddddw*w*w*w*n|w*", &fg, &B, &Wn, &H, &W, &Wb, &K,
                          &K2, &gp.min_area, &max_area, &gp.border_margin,
                          &gp.min_hollow_side, &q_out, &a_out, &v_out, &s_out, &threads,
                          &t_out))
        return NULL;
    const char *err = gated_args_error(B, Wn, H, W, Wb, K, K2, &fg, &q_out, &a_out, &v_out,
                                       &s_out);
    if (!err && threads < 1)
        err = "threads must be at least 1";
    if (!err && t_out.obj && t_out.len < 5 * (Py_ssize_t)sizeof(double))
        err = "times buffer too small";
    int rc = 0;
    if (!err) {
        gp.H = H;
        gp.W = W;
        GatedBatch job = {(const uint8_t *)fg.buf, B * Wn, H, W, Wb, K, K2, 0, max_area, &gp,
                          (float *)q_out.buf, (float *)a_out.buf, (uint8_t *)v_out.buf, 0};
        int64_t *stats = (int64_t *)s_out.buf;
        const Py_ssize_t nt = threads < job.masks ? threads : (job.masks > 0 ? job.masks : 1);
        Py_BEGIN_ALLOW_THREADS
        GatedWorker *workers = (GatedWorker *)calloc((size_t)nt, sizeof(GatedWorker));
        pthread_t *tids = (pthread_t *)calloc((size_t)nt, sizeof(pthread_t));
        char *started = (char *)calloc((size_t)nt, 1);
        if (!workers || !tids || !started) {
            rc = -1;
        } else {
            const uint64_t t0 = ticks();
            for (Py_ssize_t t = 0; t < nt; t++) workers[t].job = &job;
            for (Py_ssize_t t = 1; t < nt; t++)
                started[t] = pthread_create(&tids[t], NULL, gated_worker, &workers[t]) == 0;
            gated_worker(&workers[0]);
            for (Py_ssize_t t = 1; t < nt; t++)
                if (started[t]) pthread_join(tids[t], NULL);
            memset(stats, 0, GS_N * sizeof(int64_t));
            double times[5] = {0.0, 0.0, 0.0, (double)(ticks() - t0), 0.0};
            for (Py_ssize_t t = 0; t < nt; t++) {
                rc |= workers[t].rc;
                for (int k = 0; k < GS_N; k++) stats[k] += workers[t].stats[k];
                times[0] += (double)workers[t].labeler;
                times[1] += (double)workers[t].gates;
                times[2] += (t == 0 || started[t]) ? 1.0 : 0.0;
                times[4] += (double)workers[t].runs;
            }
            if (t_out.obj) memcpy(t_out.buf, times, sizeof(times));
        }
        free(workers);
        free(tids);
        free(started);
        Py_END_ALLOW_THREADS
    }
    PyBuffer_Release(&fg);
    PyBuffer_Release(&q_out);
    PyBuffer_Release(&a_out);
    PyBuffer_Release(&v_out);
    PyBuffer_Release(&s_out);
    if (t_out.obj) PyBuffer_Release(&t_out);
    if (err) {
        PyErr_SetString(PyExc_ValueError, err);
        return NULL;
    }
    if (rc) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

/* gate_candidates_batch(packed, B, Wn, H, W, Wb, K, K2, min_area,
 *                       border_margin, min_hollow_side, quads, areas,
 *                       counts, areas_out, valid_out, stats_out)
 *   The gates and re-fits of quad_candidates_gated_batch on slots given in
 *   quad_candidates_batch's layout: quads float32 (B, Wn*(K+K2), 4, 2),
 *   wound and re-fit in place, areas int32 (B, Wn*(K+K2)) and counts int32
 *   (B, Wn, 2) = (count8, count4) read; areas_out, valid_out and stats_out
 *   as there.  The GIL is released.  Returns None.
 */
static PyObject *gate_candidates_batch(PyObject *self, PyObject *args) {
    Py_buffer fg, q_io, a_in, n_in, a_out, v_out, s_out;
    Py_ssize_t B, Wn, H, W, Wb, K, K2;
    GateParams gp;
    if (!PyArg_ParseTuple(args, "y*nnnnnnndddw*y*y*w*w*w*", &fg, &B, &Wn, &H, &W, &Wb, &K, &K2,
                          &gp.min_area, &gp.border_margin, &gp.min_hollow_side, &q_io, &a_in,
                          &n_in, &a_out, &v_out, &s_out))
        return NULL;
    const Py_ssize_t Ks = K + K2;
    const char *err = gated_args_error(B, Wn, H, W, Wb, K, K2, &fg, &q_io, &a_out, &v_out,
                                       &s_out);
    if (!err && (a_in.len < B * Wn * Ks * (Py_ssize_t)sizeof(int32_t)
                 || n_in.len < B * Wn * 2 * (Py_ssize_t)sizeof(int32_t)))
        err = "input buffer too small";
    int rc = 0;
    if (!err) {
        const uint8_t *im = (const uint8_t *)fg.buf;
        const int32_t *areas_i = (const int32_t *)a_in.buf, *counts = (const int32_t *)n_in.buf;
        float *quads = (float *)q_io.buf, *areas = (float *)a_out.buf;
        uint8_t *valid = (uint8_t *)v_out.buf;
        int64_t *stats = (int64_t *)s_out.buf;
        gp.H = H;
        gp.W = W;
        Py_BEGIN_ALLOW_THREADS
        memset(stats, 0, GS_N * sizeof(int64_t));
        for (Py_ssize_t m = 0; m < B * Wn && !rc; m++)
            rc = gate_window(im + (size_t)m * H * Wb, Wb, &gp, K, Ks, counts[2 * m],
                             counts[2 * m + 1], quads + (size_t)m * Ks * 8,
                             areas_i + (size_t)m * Ks, areas + (size_t)m * Ks,
                             valid + (size_t)m * Ks, stats);
        Py_END_ALLOW_THREADS
    }
    PyBuffer_Release(&fg);
    PyBuffer_Release(&q_io);
    PyBuffer_Release(&a_in);
    PyBuffer_Release(&n_in);
    PyBuffer_Release(&a_out);
    PyBuffer_Release(&v_out);
    PyBuffer_Release(&s_out);
    if (err) {
        PyErr_SetString(PyExc_ValueError, err);
        return NULL;
    }
    if (rc) return PyErr_NoMemory();
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"quad_candidates", quad_candidates, METH_VARARGS,
     "Run-based union-find CCL + farthest-point quad corners."},
    {"quad_candidates_packed", quad_candidates_packed, METH_VARARGS,
     "Same, reading a bit-packed (H, Wb) mask (np.packbits little-endian)."},
    {"quad_candidates_packed2", quad_candidates_packed2, METH_VARARGS,
     "Packed variant that also emits 4-connected split candidates."},
    {"quad_candidates_batch", quad_candidates_batch, METH_VARARGS,
     "quad_candidates_packed2 over a (B, Wn, H, Wb) batch in one call, into buffers."},
    {"quad_candidates_gated_batch", quad_candidates_gated_batch, METH_VARARGS,
     "quad_candidates_batch, then the winding, gates and re-fits, in one call over threads."},
    {"gate_candidates_batch", gate_candidates_batch, METH_VARARGS,
     "The winding, gates and re-fits of quad_candidates_gated_batch on given slots."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fastccl", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit_fastccl(void) { return PyModule_Create(&moduledef); }
