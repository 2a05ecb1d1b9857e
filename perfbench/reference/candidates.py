"""Frames -> quad candidates on the host, plain numpy and scipy: a frozen
copy of the port's plain versions (its numpy threshold, scipy labeler and
numpy gates), and the upstream project's preprocess.

For each frame and window size: the mean-C adaptive threshold, the 8- and
4-connected components, the largest ``max_candidates`` (and
``max_candidates_4conn`` split) components' farthest-point quads, the
clockwise winding, the validity gates and the re-fit of degenerate quads
on the component's convex hull.
"""
from __future__ import annotations

import numpy as np


def host_preprocess(images: np.ndarray, brightness: float, contrast: float) -> np.ndarray:
    """The upstream project's contrast and brightness (its cam.py:137-145):
    float32 scale, clip, uint8 truncation, then OpenCV's BGR2GRAY for
    ``(N, H, W, 3)`` BGR input."""
    if contrast == 0 and brightness == 0:
        x = images
    else:
        x = images.astype(np.float32)
        if contrast != 0:
            x = x * (contrast / 127.0 + 1.0) - contrast
        x = x + brightness
        x = np.clip(x, 0.0, 255.0).astype(np.uint8)
    if x.ndim == 4 and x.shape[-1] == 3:
        import cv2 as cv

        x = np.stack([cv.cvtColor(im, cv.COLOR_BGR2GRAY) for im in x])
    return x


def _quad_gates(quads: np.ndarray, areas: np.ndarray, H: int, W: int, params) -> np.ndarray:
    """The candidates' validity gates: area, shortest edge, inside the
    border margin, convex, and solid enough or an outline."""
    x = quads[..., 0]
    y = quads[..., 1]
    x2 = np.roll(x, -1, axis=-1)
    y2 = np.roll(y, -1, axis=-1)
    shoelace = np.sum(x * y2 - x2 * y, axis=-1)
    quad_area = 0.5 * np.abs(shoelace)
    edges = np.roll(quads, -1, axis=-2) - quads
    edge_len = np.linalg.norm(edges, axis=-1)
    e_next = np.roll(edges, -1, axis=-2)
    crosses = edges[..., 0] * e_next[..., 1] - edges[..., 1] * e_next[..., 0]
    convex = (crosses > 0).all(-1) | (crosses < 0).all(-1)
    m = params.border_margin
    inside = (
        (quads[..., 0] >= m).all(-1)
        & (quads[..., 0] <= W - 1 - m).all(-1)
        & (quads[..., 1] >= m).all(-1)
        & (quads[..., 1] <= H - 1 - m).all(-1)
    )
    fill = areas / np.maximum(quad_area, 1.0)
    # Solid-enough blob OR a ring/outline: large markers hollow under the
    # adaptive threshold (window << border-ring thickness leaves only a
    # ~win/2 band along each edge), so their component is a thin square
    # annulus whose fill ratio drops with marker size.  An annulus of
    # thickness t has area ~ t * perimeter — accept components at least
    # 1 px "thick" along their quad outline, but ONLY at the quad sizes
    # where hollowing can occur (ring thickness = side/6 exceeding the
    # largest window), so ordinary-size junk keeps facing the fill gate
    # (OpenCV's contour extraction has no fill gate; decode is the backstop).
    perim = edge_len.sum(-1)
    min_hollow_side = _min_hollow_side(params)
    outline = (areas >= np.maximum(perim, 1.0)) & (
        quad_area >= min_hollow_side * min_hollow_side
    )
    return (
        (areas >= params.min_area)
        & (edge_len.min(-1) >= 5.0)
        & inside
        & convex
        & ((fill > 0.2) | outline)
    )


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew monotone chain over integer points sorted lexicographically
    by (x, y) (exact integer cross products; collinear points dropped)."""
    def half(points):
        out: list = []
        for px, py in points:
            while len(out) >= 2:
                ax, ay = out[-2]
                bx, by = out[-1]
                if (bx - ax) * (py - ay) - (by - ay) * (px - ax) <= 0:
                    out.pop()
                else:
                    break
            out.append((px, py))
        return out

    if len(pts) <= 2:
        return pts
    plist = [(int(x), int(y)) for x, y in pts]  # python ints: ~4x faster loop
    lower = half(plist)
    upper = half(plist[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def _max_area_quad(hull: np.ndarray) -> np.ndarray:
    """Maximum-area quadrilateral with vertices on the convex hull: for
    every vertex pair (a, b) take the farthest hull point on each side of
    the a->b line (the max-area completion for that diagonal/edge), keep
    the best.  O(h^2) over the (small) hull."""
    h = len(hull)
    best_area = -1.0
    best = hull[[0, 0, 0, 0]] if h < 4 else None
    for i in range(h - 1):
        dx = hull[:, 0] - hull[i, 0]
        dy = hull[:, 1] - hull[i, 1]
        ex, ey = dx[i + 1:], dy[i + 1:]  # a->b vectors for every j > i
        cr = dx[:, None] * ey[None, :] - dy[:, None] * ex[None, :]
        up, dn = cr.argmax(0), cr.argmin(0)
        cols = np.arange(cr.shape[1])
        areas = np.abs(cr[up, cols]) + np.abs(cr[dn, cols])
        jr = int(np.argmax(areas))
        if areas[jr] > best_area:
            best_area = float(areas[jr])
            best = np.stack([hull[i], hull[up[jr]], hull[i + 1 + jr],
                             hull[dn[jr]]])
    return np.asarray(best, np.float64)


def _refit_degenerate_quad(mask, quad, area, H, W, conn4=False):
    """Re-fit a candidate whose farthest-point quad degenerated.

    At extreme oblique view angles a marker's long SIDE exceeds its
    diagonal, so "farthest from p1" lands on the adjacent long-side corner
    instead of the diagonal one and two extracted corners collapse (the
    min-edge gate then rejects the candidate outright).  OpenCV escapes
    through the AprilTag quad detector's gradient clustering
    (reference cam.py:147); the geometric equivalent here is the
    MAXIMUM-AREA QUADRILATERAL ON THE COMPONENT'S CONVEX HULL, which
    recovers the true corners to ~1 px on these shapes; the decode stage
    remains the backstop, so a bad re-fit can never produce a false id.  Returns the re-fit quad (float64
    (4, 2)) or None.
    """
    from scipy import ndimage

    x0, x1 = float(quad[:, 0].min()), float(quad[:, 0].max())
    y0, y1 = float(quad[:, 1].min()), float(quad[:, 1].max())
    margin = 32  # the expansion loop below widens if the component is clipped
    for _expand in range(4):
        ax0, ay0 = max(0, int(x0) - margin), max(0, int(y0) - margin)
        ax1, ay1 = min(W, int(x1) + margin + 1), min(H, int(y1) + margin + 1)
        crop = mask[ay0:ay1, ax0:ax1]
        # connectivity must match the slot class, or the area check can
        # never pass: split slots carry 4-connected sub-components whose
        # area is a strict subset of their 8-connected parent
        structure = None if conn4 else np.ones((3, 3), np.int32)
        lab, _n = ndimage.label(crop, structure=structure)
        cx, cy = int(quad[0, 0]) - ax0, int(quad[0, 1]) - ay0
        if not (0 <= cy < lab.shape[0] and 0 <= cx < lab.shape[1]):
            return None
        lid = lab[cy, cx]
        if lid == 0:
            return None
        sel = lab == lid
        if int(sel.sum()) == int(area):
            break  # full component inside the crop
        # Widen ONLY when the component is clipped by a crop edge that is
        # not also an image edge; any other area mismatch means the corner
        # pixel landed in a different component — give up (rare).
        clipped = ((ay0 > 0 and sel[0].any())
                   or (ay1 < H and sel[-1].any())
                   or (ax0 > 0 and sel[:, 0].any())
                   or (ax1 < W and sel[:, -1].any()))
        if not clipped:
            return None
        margin *= 2
    else:
        return None
    ys, xs = np.nonzero(sel)  # row-major: ys sorted, xs ascending per row
    rows, first = np.unique(ys, return_index=True)
    last = np.r_[first[1:], ys.size] - 1
    # hull vertices are per-row x-extremes; integer coords, global frame
    pts = np.unique(np.concatenate([
        np.stack([xs[first] + ax0, rows + ay0], 1),
        np.stack([xs[last] + ax0, rows + ay0], 1),
    ]), axis=0)
    hull = _convex_hull(pts)
    if len(hull) < 4:
        return None
    return _max_area_quad(hull.astype(np.float64))


def _min_hollow_side(params) -> float:
    """The side from which a quad may pass the gates as an outline
    (:func:`_quad_gates`)."""
    return 4.0 * max(params.win_sizes)


def _candidates_scipy(fg: np.ndarray, K: int, K2: int, min_area, max_area):
    """Quad candidates of one mask by ``scipy.ndimage``'s labels:


    - component numbering: ``ndimage.label`` assigns labels in raster-scan
      order of first encounter, the slot order;
    - top-K: no sort at all when at most K candidates pass the area filter
      (scan order kept), else a first-max selection sort whose swaps are
      tie-unstable;
    - corners: farthest-point corners over the component's pixels in (y, x)
      scan order, first maximum on ties;
    - splits: 4-connected components that are strict subsets of their
      8-connected parent (area4 < area8).
    """
    from scipy import ndimage

    fg = np.ascontiguousarray(fg, dtype=np.uint8)
    lab8, n8 = ndimage.label(fg, structure=np.ones((3, 3), np.int32))
    corners = np.zeros((K + K2, 4, 2), np.float32)
    areas_out = np.zeros((K + K2,), np.int32)
    lo, hi = int(min_area), int(max_area)

    def emit(lab, keep_ids, Kslots, base):
        objs = ndimage.find_objects(lab)
        for a, lid in enumerate(keep_ids[:Kslots]):
            sl = objs[lid - 1]
            ys, xs = np.nonzero(lab[sl] == lid)  # (y, x) scan order
            xs = xs.astype(np.float64) + sl[1].start
            ys = ys.astype(np.float64) + sl[0].start
            area = xs.shape[0]
            cx = xs.sum() / area
            cy = ys.sum() / area
            i1 = np.argmax((xs - cx) * (xs - cx) + (ys - cy) * (ys - cy))
            p1x, p1y = xs[i1], ys[i1]
            i2 = np.argmax((xs - p1x) * (xs - p1x) + (ys - p1y) * (ys - p1y))
            p2x, p2y = xs[i2], ys[i2]
            dx, dy = p2x - p1x, p2y - p1y
            c = (xs - p1x) * dy - (ys - p1y) * dx
            i3, i4 = np.argmax(c), np.argmin(c)
            corners[base + a] = [[p1x, p1y], [xs[i3], ys[i3]],
                                 [p2x, p2y], [xs[i4], ys[i4]]]
            areas_out[base + a] = area
        return min(len(keep_ids), Kslots)

    def top_k_c(ids, areas, Kslots):
        ids = list(ids)
        if len(ids) > Kslots:
            for a in range(Kslots):
                best = a
                for b in range(a + 1, len(ids)):
                    if areas[ids[b]] > areas[ids[best]]:
                        best = b
                ids[a], ids[best] = ids[best], ids[a]
            ids = ids[:Kslots]
        return np.asarray(ids, np.int64) + 1  # 0-based -> label ids

    area8 = np.bincount(lab8.ravel(), minlength=n8 + 1)[1:]
    kept8 = np.nonzero((area8 >= lo) & (area8 <= hi))[0]
    nkeep8 = emit(lab8, top_k_c(kept8, area8, K), K, 0)

    nkeep4 = 0
    if K2 > 0:
        lab4, n4 = ndimage.label(fg)  # default structure = 4-connectivity
        if n4 > n8:  # otherwise every 4-conn component == its 8-conn parent
            area4 = np.bincount(lab4.ravel(), minlength=n4 + 1)[1:]
            # 8-conn parent area looked up at each 4-component's first pixel
            flat4 = lab4.ravel()
            idx = np.nonzero(flat4)[0]
            _, firsts = np.unique(flat4[idx], return_index=True)  # labels 1..n4
            parent8 = area8[lab8.ravel()[idx[firsts]] - 1]
            kept4 = np.nonzero(
                (area4 >= lo) & (area4 <= hi) & (area4 < parent8)
            )[0]
            nkeep4 = emit(lab4, top_k_c(kept4, area4, K2), K2, K)

    return corners.tobytes(), areas_out.tobytes(), nkeep8, nkeep4


def _scipy_slots(fg: np.ndarray, params):
    """The labeler's slots, window by window, on ``(B, Wn, H, W)`` masks:
    ``(corners (B, Wn*Ks, 4, 2) float32, areas (B, Wn*Ks) int32, counts
    (B, Wn, 2))`` with ``Ks = K + K2`` slots a window and counts
    ``(n8, n4)``."""
    B, Wn, H, W = fg.shape
    K, K2 = params.max_candidates, params.max_candidates_4conn
    Ks = K + K2
    quads = np.zeros((B, Wn * Ks, 4, 2), np.float32)
    areas = np.zeros((B, Wn * Ks), np.int32)
    counts = np.zeros((B, Wn, 2), np.int32)
    for b in range(B):
        for wi in range(Wn):
            c_bytes, a_bytes, n8, n4 = _candidates_scipy(
                fg[b, wi], K, K2, params.min_area, params.max_area_rate * H * W)
            sl = slice(wi * Ks, (wi + 1) * Ks)
            quads[b, sl] = np.frombuffer(c_bytes, np.float32).reshape(Ks, 4, 2)
            areas[b, sl] = np.frombuffer(a_bytes, np.int32)
            counts[b, wi] = n8, n4
    return quads, areas, counts


def _gated_candidates(quads, areas, counts, mask_of, H, W, params):
    """The labeler's slots (:func:`_scipy_slots`) -> ``(quads, valid,
    areas float32)``: the emitted
    slots (the first ``n8`` of a window's K 8-connected slots, the first
    ``n4`` of its K2 split slots), clockwise winding, the validity gates.
    ``mask_of(b, wi)`` provides the window's foreground mask so
    gate-rejected candidates can be re-fit (see
    :func:`_refit_degenerate_quad`)."""
    K = params.max_candidates
    Ks = K + params.max_candidates_4conn
    B, Wn = counts.shape[:2]
    slot = np.arange(Ks)
    valid = ((slot < counts[..., :1])
             | ((slot >= K) & (slot < K + counts[..., 1:]))).reshape(B, Wn * Ks)
    areas = areas.astype(np.float32)

    # enforce clockwise winding (image coords): positive shoelace
    x = quads[..., 0]
    y = quads[..., 1]
    shoelace = np.sum(x * np.roll(y, -1, -1) - np.roll(x, -1, -1) * y, axis=-1)
    flip = shoelace < 0
    quads[flip] = quads[flip][:, [0, 3, 2, 1]]

    emitted = valid
    valid = emitted & _quad_gates(quads, areas, H, W, params)

    # Degenerate-extraction recovery: an extractor-emitted candidate
    # that the shape gates reject may be an extreme-oblique marker
    # whose farthest-point corners collapsed; re-fit the max-area
    # hull quad and re-gate (decode is the backstop downstream).
    # Trigger ONLY on the degeneracy signature — a collapsed corner
    # pair (tiny edge) or a non-convex corner order — so ordinary
    # fill-gate junk never pays the re-fit (scipy label on a crop).
    edges_ = np.roll(quads, -1, axis=-2) - quads
    elen_ = np.linalg.norm(edges_, axis=-1)
    enx_ = np.roll(edges_, -1, axis=-2)
    cr_ = edges_[..., 0] * enx_[..., 1] - edges_[..., 1] * enx_[..., 0]
    degen = (elen_.min(-1) < 5.0) | ~((cr_ > 0).all(-1) | (cr_ < 0).all(-1))
    masks: dict = {}  # several rejects often share a window: unpack once
    for b, s in zip(*np.nonzero(emitted & ~valid & degen)):
        wi = s // Ks
        if (b, wi) not in masks:
            masks[(b, wi)] = mask_of(b, wi)
        q2 = _refit_degenerate_quad(
            masks[(b, wi)], quads[b, s], areas[b, s], H, W,
            conn4=(s % Ks) >= K)  # split slots hold 4-conn components
        if q2 is None:
            continue
        sh = np.sum(q2[:, 0] * np.roll(q2[:, 1], -1)
                    - np.roll(q2[:, 0], -1) * q2[:, 1])
        if sh < 0:
            q2 = q2[[0, 3, 2, 1]]
        if _quad_gates(q2[None, None], areas[b, s][None, None],
                       H, W, params)[0, 0]:
            quads[b, s] = q2
            valid[b, s] = True
    return quads, valid, areas


def threshold_masks(g: np.ndarray, wins, C) -> np.ndarray:
    """The mean-C adaptive threshold of one uint8 frame at every window
    size: ``(len(wins), H, W)`` bool, foreground where the pixel is at most
    its replicate-padded box mean minus C.  One int32 integral image serves
    every window; an integral C compares exactly in integers,
    ``(g + C) * win^2 <= boxsum``."""
    H, W = g.shape
    R = max(w // 2 for w in wins)
    gp = np.pad(g, R, mode="edge").astype(np.int32)
    ii = np.zeros((H + 2 * R + 1, W + 2 * R + 1), np.int32)
    np.cumsum(np.cumsum(gp, axis=0), axis=1, out=ii[1:, 1:])
    out = np.empty((len(wins), H, W), bool)
    gi = g.astype(np.int32)
    c_int = float(C).is_integer()
    for wi, win in enumerate(wins):
        r = win // 2
        a, b = R - r, R + r + 1  # padded-coord offsets of the window box
        s = (ii[b:b + H, b:b + W] - ii[a:a + H, b:b + W]
             - ii[b:b + H, a:a + W] + ii[a:a + H, a:a + W])
        if c_int:
            fg = (gi + int(C)) * (win * win) <= s
        else:
            fg = gi.astype(np.float64) <= s.astype(np.float64) / (win * win) - C
        out[wi] = fg
    return out


def candidates(gray: np.ndarray, params):
    """uint8 frames ``(B, H, W)`` -> ``(quads (B, Q, 4, 2) float32, valid
    (B, Q) bool, areas (B, Q) float32)``, ``Q = Wn * (max_candidates +
    max_candidates_4conn)``."""
    B, H, W = gray.shape
    wins = tuple(int(w) for w in params.win_sizes)
    fg = np.stack([threshold_masks(np.ascontiguousarray(g), wins, params.thresh_const)
                   for g in gray])
    return _gated_candidates(*_scipy_slots(fg, params), lambda b, wi: fg[b, wi], H, W, params)
