/* quad_gates.h — the validity gates and the degenerate re-fit of
 * perception's host candidates, included by fastccl.c after the labeler.
 *
 * The C form of vican_torch/perception.py's numpy tail, _gated_candidates:
 * the clockwise winding, _quad_gates, and for an emitted slot that the
 * gates reject with the degeneracy signature, _refit_degenerate_quad with
 * _convex_hull and _max_area_quad, then the re-fit quad's winding and
 * re-gate (vican_tpu/perception.py:141-276, 425-493).  Its output equals
 * the numpy version's byte for byte (tests/test_torch_gates.py):
 *
 * - Float width and order follow numpy.  The main gate runs in float32 on
 *   the labeler's corners, the re-fit's re-gate in float64 (numpy's re-fit
 *   quad is float64; its areas stay float32).  Every product is rounded
 *   before it is added, every 4-corner sum runs in corner order (numpy's
 *   reduction of 4 elements), an edge length is sqrt(dx*dx + dy*dy) in the
 *   quad's type, and the parameters enter a float32 comparison as float32,
 *   as NEP 50 casts a Python scalar.
 * - No multiply-add is fused.  Under -march=native gcc's default
 *   -ffp-contract=fast may turn a*b - c*d into one rounding where numpy
 *   rounds twice, which moves a shoelace or a convexity cross off numpy's
 *   value once the products pass float32's exact integers (2^24).  So
 *   everything in this file compiles with fp-contract off (the pragma
 *   below, popped at its end), while the labeler above the #include keeps
 *   the module's flags and so the JAX package's build.
 * - The re-fit labels nothing.  ndimage.label of the crop, then the label
 *   under the seed pixel, is the seed's component in the crop: a flood fill
 *   from the seed over the crop, in the slot's connectivity, gives the same
 *   pixels, so the same area, the same per-row extremes and the same
 *   contact with each crop edge.  It reads the packed bits in place.
 * - Hull points are integers, so the hull's and the quad search's cross
 *   products are exact in int64 (numpy's are exact in float64 at these
 *   sizes); ties break on the first index, as numpy's argmax and argmin.
 *
 * Nothing here touches a Python object: the callers run it with the GIL
 * released.  Each re-fit adds to the counters of GateStat. */

#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")

/* counters of the re-fit branches, in the order of the stats buffer */
enum GateStat {
    GS_REFITS,    /* re-fits tried: emitted, gate-rejected, degenerate slots */
    GS_CONN4,     /* of them, split slots (4-connected components) */
    GS_WIDENED,   /* crops widened: the component was clipped by a crop edge */
    GS_CLAMPED,   /* re-fits whose crop was bounded by an image edge */
    GS_MISMATCH,  /* None: seed outside the crop or on background, or an area
                     mismatch with no clipped crop edge */
    GS_EXHAUSTED, /* None: still clipped after the fourth crop */
    GS_NO_HULL,   /* None: a hull of fewer than 4 points */
    GS_REJECTED,  /* re-fit quads that the re-gate rejected */
    GS_ACCEPTED,  /* re-fit quads written back as valid */
    GS_N
};

typedef struct {
    Py_ssize_t H, W;
    double min_area, border_margin, min_hollow_side;
} GateParams;

/* _quad_gates on one quad q[4][2] of type T with its component's area;
 * *degen (when not NULL) gets the re-fit trigger: an edge under 5 px or a
 * corner order that is not convex. */
#define DEFINE_QUAD_GATE(NAME, T, SQRT)                                              \
    static int NAME(const T *q, float area, const GateParams *p, int *degen) {      \
        T shoe = 0, e[8], len[4], mn = 0, perim, qa, fill;                          \
        int pos = 1, neg = 1, inside = 1;                                           \
        for (int k = 0; k < 4; k++) {                                               \
            int n = (k + 1) & 3;                                                    \
            shoe += q[2 * k] * q[2 * n + 1] - q[2 * n] * q[2 * k + 1];              \
            e[2 * k] = q[2 * n] - q[2 * k];                                         \
            e[2 * k + 1] = q[2 * n + 1] - q[2 * k + 1];                             \
        }                                                                           \
        for (int k = 0; k < 4; k++) {                                               \
            int n = (k + 1) & 3;                                                    \
            T cr = e[2 * k] * e[2 * n + 1] - e[2 * k + 1] * e[2 * n];               \
            len[k] = SQRT(e[2 * k] * e[2 * k] + e[2 * k + 1] * e[2 * k + 1]);       \
            if (k == 0 || len[k] < mn) mn = len[k];                                 \
            pos &= cr > 0;                                                          \
            neg &= cr < 0;                                                          \
        }                                                                           \
        if (degen) *degen = mn < (T)5.0 || !(pos || neg);                           \
        const T lo = (T)p->border_margin;                                           \
        const T hx = (T)((double)(p->W - 1) - p->border_margin);                    \
        const T hy = (T)((double)(p->H - 1) - p->border_margin);                    \
        for (int k = 0; k < 4; k++)                                                 \
            inside &= q[2 * k] >= lo && q[2 * k] <= hx && q[2 * k + 1] >= lo        \
                      && q[2 * k + 1] <= hy;                                        \
        qa = (T)0.5 * (shoe < 0 ? -shoe : shoe);                                    \
        fill = (T)area / (qa > (T)1.0 ? qa : (T)1.0);                               \
        perim = ((len[0] + len[1]) + len[2]) + len[3];                              \
        int outline = (T)area >= (perim > (T)1.0 ? perim : (T)1.0)                  \
                      && qa >= (T)(p->min_hollow_side * p->min_hollow_side);        \
        return area >= (float)p->min_area && mn >= (T)5.0 && inside                 \
               && (pos || neg) && (fill > (T)0.2 || outline);                       \
    }

DEFINE_QUAD_GATE(quad_gate_f32, float, sqrtf)
DEFINE_QUAD_GATE(quad_gate_f64, double, sqrt)

/* the winding: corners (0, 3, 2, 1) when the shoelace is negative */
#define DEFINE_WIND(NAME, T)                                                        \
    static void NAME(T *q) {                                                        \
        T shoe = 0;                                                                 \
        for (int k = 0; k < 4; k++) {                                               \
            int n = (k + 1) & 3;                                                    \
            shoe += q[2 * k] * q[2 * n + 1] - q[2 * n] * q[2 * k + 1];              \
        }                                                                           \
        if (shoe < 0) {                                                             \
            T x = q[2], y = q[3];                                                   \
            q[2] = q[6]; q[3] = q[7];                                               \
            q[6] = x; q[7] = y;                                                     \
        }                                                                           \
    }

DEFINE_WIND(wind_f32, float)
DEFINE_WIND(wind_f64, double)

static inline int mask_bit(const uint8_t *mask, Py_ssize_t Wb, Py_ssize_t y, Py_ssize_t x) {
    return (mask[y * Wb + (x >> 3)] >> (x & 7)) & 1;
}

static int cmp_i64(const void *a, const void *b) {
    int64_t x = *(const int64_t *)a, y = *(const int64_t *)b;
    return (x > y) - (x < y);
}

/* One half of Andrew's monotone chain over n points sorted by (x, y),
 * walked forward or backward; collinear points are dropped.  Returns the
 * chain's length. */
static Py_ssize_t hull_chain(const int64_t *px, const int64_t *py, Py_ssize_t n, int backward,
                             int64_t *ox, int64_t *oy) {
    Py_ssize_t m = 0;
    for (Py_ssize_t t = 0; t < n; t++) {
        Py_ssize_t i = backward ? n - 1 - t : t;
        while (m >= 2 && (ox[m - 1] - ox[m - 2]) * (py[i] - oy[m - 2])
                                 - (oy[m - 1] - oy[m - 2]) * (px[i] - ox[m - 2]) <= 0)
            m--;
        ox[m] = px[i];
        oy[m] = py[i];
        m++;
    }
    return m;
}

/* _max_area_quad over a hull of h >= 4 points: for every pair (i, j > i)
 * the farthest hull point on each side of the i->j line, the pair whose
 * two triangles sum largest (first pair on ties).  Writes float64 corners
 * (i, up, j, dn). */
static void max_area_quad(const int64_t *hx, const int64_t *hy, Py_ssize_t h, double *out) {
    int64_t best = -1;
    for (Py_ssize_t i = 0; i + 1 < h; i++) {
        int64_t amax = -1;
        Py_ssize_t jr = 0, ur = 0, dr = 0;
        for (Py_ssize_t j = i + 1; j < h; j++) {
            const int64_t ex = hx[j] - hx[i], ey = hy[j] - hy[i];
            int64_t cmax = 0, cmin = 0;
            Py_ssize_t up = 0, dn = 0;
            for (Py_ssize_t k = 0; k < h; k++) {
                const int64_t c = (hx[k] - hx[i]) * ey - (hy[k] - hy[i]) * ex;
                if (k == 0 || c > cmax) { cmax = c; up = k; }
                if (k == 0 || c < cmin) { cmin = c; dn = k; }
            }
            const int64_t a = (cmax < 0 ? -cmax : cmax) + (cmin < 0 ? -cmin : cmin);
            if (a > amax) { amax = a; jr = j; ur = up; dr = dn; }
        }
        if (amax > best) {
            const Py_ssize_t v[4] = {i, ur, jr, dr};
            best = amax;
            for (int k = 0; k < 4; k++) {
                out[2 * k] = (double)hx[v[k]];
                out[2 * k + 1] = (double)hy[v[k]];
            }
        }
    }
}

/* The seed's component in the crop [ay0, ay1) x [ax0, ax1) of the packed
 * window, 8- or 4-connected: its pixel count, the first and last x of each
 * crop row (rowmax < 0 on a row it misses), and which crop edges it touches
 * (bits 1 top, 2 bottom, 4 left, 8 right).  Returns the count, or -1 when
 * out of memory. */
static Py_ssize_t crop_component(const uint8_t *mask, Py_ssize_t Wb, Py_ssize_t ax0,
                                 Py_ssize_t ay0, Py_ssize_t cw, Py_ssize_t ch, Py_ssize_t cx,
                                 Py_ssize_t cy, int conn4, int32_t *rowmin, int32_t *rowmax,
                                 int *touch) {
    static const int dx8[8] = {-1, 0, 1, -1, 1, -1, 0, 1}, dy8[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
    static const int dx4[4] = {0, -1, 1, 0}, dy4[4] = {-1, 0, 0, 1};
    const int *dx = conn4 ? dx4 : dx8, *dy = conn4 ? dy4 : dy8, nn = conn4 ? 4 : 8;
    uint8_t *seen = (uint8_t *)calloc((size_t)cw * (size_t)ch, 1);
    Py_ssize_t cap = 4096, top = 0, count = 0;
    Py_ssize_t *stack = (Py_ssize_t *)malloc((size_t)cap * sizeof(Py_ssize_t));
    if (!seen || !stack) { free(seen); free(stack); return -1; }
    for (Py_ssize_t r = 0; r < ch; r++) { rowmin[r] = INT32_MAX; rowmax[r] = -1; }
    *touch = 0;
    seen[cy * cw + cx] = 1;
    stack[top++] = cy * cw + cx;
    while (top > 0) {
        const Py_ssize_t at = stack[--top], y = at / cw, x = at % cw;
        count++;
        if (x < rowmin[y]) rowmin[y] = (int32_t)x;
        if (x > rowmax[y]) rowmax[y] = (int32_t)x;
        *touch |= (y == 0) | (y == ch - 1) << 1 | (x == 0) << 2 | (x == cw - 1) << 3;
        for (int d = 0; d < nn; d++) {
            const Py_ssize_t X = x + dx[d], Y = y + dy[d];
            if (X < 0 || X >= cw || Y < 0 || Y >= ch || seen[Y * cw + X]
                || !mask_bit(mask, Wb, ay0 + Y, ax0 + X))
                continue;
            seen[Y * cw + X] = 1;
            if (top == cap) {
                cap *= 2;
                Py_ssize_t *grown = (Py_ssize_t *)realloc(stack, (size_t)cap * sizeof(Py_ssize_t));
                if (!grown) { free(seen); free(stack); return -1; }
                stack = grown;
            }
            stack[top++] = Y * cw + X;
        }
    }
    free(seen);
    free(stack);
    return count;
}

/* _refit_degenerate_quad on one slot: 1 with the maximum-area hull quad in
 * out (float64, before its winding), 0 for None, -1 when out of memory.
 * The crop is int(corner) -+ margin around the quad's corners, margin 32,
 * doubled while the seed's component is clipped by a crop edge that is not
 * an image edge, four crops at most.  Corners that are not finite or lie
 * past +-1e15 (never the labeler's) give None. */
static int refit_quad(const uint8_t *mask, Py_ssize_t Wb, const GateParams *p, const float *quad,
                      float area, int conn4, double *out, int64_t *stats) {
    const Py_ssize_t H = p->H, W = p->W;
    stats[GS_REFITS]++;
    stats[GS_CONN4] += conn4;
    for (int k = 0; k < 8; k++)
        if (!(fabs((double)quad[k]) < 1e15)) { stats[GS_MISMATCH]++; return 0; }
    double x0 = quad[0], x1 = quad[0], y0 = quad[1], y1 = quad[1];
    for (int k = 1; k < 4; k++) {
        x0 = fmin(x0, quad[2 * k]); x1 = fmax(x1, quad[2 * k]);
        y0 = fmin(y0, quad[2 * k + 1]); y1 = fmax(y1, quad[2 * k + 1]);
    }
    Py_ssize_t margin = 32, ax0 = 0, ay0 = 0, cw = 0, ch = 0, found = 0;
    int32_t *rowmin = NULL, *rowmax = NULL;
    int clamped = 0, rc = 0;
    for (int expand = 0; expand < 4 && !found; expand++, margin *= 2) {
        if (expand) stats[GS_WIDENED]++;
        ax0 = (Py_ssize_t)x0 - margin; ay0 = (Py_ssize_t)y0 - margin;
        ax0 = ax0 > 0 ? ax0 : 0; ay0 = ay0 > 0 ? ay0 : 0;
        Py_ssize_t ax1 = (Py_ssize_t)x1 + margin + 1, ay1 = (Py_ssize_t)y1 + margin + 1;
        ax1 = ax1 < W ? ax1 : W; ay1 = ay1 < H ? ay1 : H;
        cw = ax1 - ax0; ch = ay1 - ay0;
        const Py_ssize_t cx = (Py_ssize_t)quad[0] - ax0, cy = (Py_ssize_t)quad[1] - ay0;
        if (!(0 <= cy && cy < ch && 0 <= cx && cx < cw)
            || !mask_bit(mask, Wb, ay0 + cy, ax0 + cx)) {
            stats[GS_MISMATCH]++;
            goto done;
        }
        clamped |= ax0 == 0 || ay0 == 0 || ax1 == W || ay1 == H;
        free(rowmin); free(rowmax);
        rowmin = (int32_t *)malloc((size_t)ch * sizeof(int32_t));
        rowmax = (int32_t *)malloc((size_t)ch * sizeof(int32_t));
        int touch;
        const Py_ssize_t n = rowmin && rowmax
            ? crop_component(mask, Wb, ax0, ay0, cw, ch, cx, cy, conn4, rowmin, rowmax, &touch)
            : -1;
        if (n < 0) { rc = -1; goto done; }
        if (n == (Py_ssize_t)area) { found = 1; break; }
        /* widen only when a crop edge that is not an image edge clips it */
        if (!(((touch & 1) && ay0 > 0) || ((touch & 2) && ay1 < H)
              || ((touch & 4) && ax0 > 0) || ((touch & 8) && ax1 < W))) {
            stats[GS_MISMATCH]++;
            goto done;
        }
    }
    if (!found) { stats[GS_EXHAUSTED]++; goto done; }
    {
        /* hull points: each row's first and last x, global frame, sorted by
         * (x, y) without repeats, as np.unique(axis=0) leaves them */
        const size_t m = (size_t)(2 * ch + 1);
        /* the points, then the hull: lower[:-1] takes at most m - 1 places
         * and the upper chain, written after it, at most m */
        int64_t *key = (int64_t *)malloc(m * sizeof(int64_t));
        int64_t *pt = (int64_t *)malloc(6 * m * sizeof(int64_t));
        if (!key || !pt) { free(key); free(pt); rc = -1; goto done; }
        Py_ssize_t n = 0, u = 0;
        for (Py_ssize_t r = 0; r < ch; r++) {
            if (rowmax[r] < 0) continue;
            key[n++] = (int64_t)(rowmin[r] + ax0) << 32 | (int64_t)(r + ay0);
            key[n++] = (int64_t)(rowmax[r] + ax0) << 32 | (int64_t)(r + ay0);
        }
        qsort(key, (size_t)n, sizeof(int64_t), cmp_i64);
        int64_t *px = pt, *py = pt + m, *hx = pt + 2 * m, *hy = pt + 4 * m;
        for (Py_ssize_t i = 0; i < n; i++) {
            if (i && key[i] == key[i - 1]) continue;
            px[u] = key[i] >> 32;
            py[u] = key[i] & 0xffffffff;
            u++;
        }
        Py_ssize_t h = 0;
        if (u >= 4) {
            /* lower[:-1] + upper[:-1] */
            h = hull_chain(px, py, u, 0, hx, hy) - 1;
            h += hull_chain(px, py, u, 1, hx + h, hy + h) - 1;
        }
        if (h < 4) {
            stats[GS_NO_HULL]++;
        } else {
            max_area_quad(hx, hy, h, out);
            rc = 1;
        }
        free(key); free(pt);
    }
done:
    stats[GS_CLAMPED] += clamped;
    free(rowmin); free(rowmax);
    return rc;
}

/* The tail of one window's Ks slots (K 8-connected, then the split slots),
 * in place: quads (Ks, 4, 2) float32 as the labeler wrote them get their
 * winding, and an emitted slot whose gates fail with the degeneracy
 * signature its re-fit; areas_in are the labeler's int32 areas, areas_out
 * and valid (0/1) are written.  mask is the window's (H, Wb) packed rows.
 * Returns 0, or -1 when out of memory. */
static int gate_window(const uint8_t *mask, Py_ssize_t Wb, const GateParams *p, Py_ssize_t K,
                       Py_ssize_t Ks, Py_ssize_t n8, Py_ssize_t n4, float *quads,
                       const int32_t *areas_in, float *areas_out, uint8_t *valid,
                       int64_t *stats) {
    for (Py_ssize_t s = 0; s < Ks; s++) {
        float *q = quads + 8 * s;
        const float area = (float)areas_in[s];
        const int emitted = s < n8 || (s >= K && s < K + n4);
        int degen;
        areas_out[s] = area;
        wind_f32(q);
        valid[s] = quad_gate_f32(q, area, p, &degen) && emitted;
        if (!emitted || valid[s] || !degen) continue;
        double q2[8] = {0};
        const int rc = refit_quad(mask, Wb, p, q, area, s >= K, q2, stats);
        if (rc < 0) return -1;
        if (rc == 0) continue;
        wind_f64(q2);
        if (!quad_gate_f64(q2, area, p, NULL)) {
            stats[GS_REJECTED]++;
            continue;
        }
        for (int k = 0; k < 8; k++) q[k] = (float)q2[k];
        valid[s] = 1;
        stats[GS_ACCEPTED]++;
    }
    return 0;
}

#pragma GCC pop_options
