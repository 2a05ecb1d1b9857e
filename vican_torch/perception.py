"""Batched perception: frames -> camera-marker edge dict.

The port of ``vican_tpu.perception``.  Per batch of frames, in the
``"device"`` pipeline mode (the default: ``"auto"`` resolves to it, the
mode the JAX package recommends for an accelerator on PCIe,
vican_tpu/perception.py:21-26):

1. upload the uint8 gray batch to the card;
2. threshold it at every window size in ONE launch of the CUDA kernel
   ``vican_torch/csrc/threshold.cu`` (:func:`vican_torch.ops.threshold.
   multi_threshold`), which returns bit-packed masks;
3. fetch the packed masks (W/8 bytes per row and window) to the host;
4. extract quad candidates on the host: the run-based union-find of
   ``_native/fastccl.c`` reads the packed rows directly, then winds, gates
   and re-fits the candidates (``_native/quad_gates.h``), the whole batch
   in one call without the GIL (the scipy.ndimage labeler and the numpy
   gates, bit-identical by construction, when the C build fails;
   :data:`last_labeler` and :data:`last_gates` say which ran);
5. refine, decode and deduplicate the candidates on the card over the
   resident frame (:mod:`vican_torch.ops.detect`);
6. solve each detection's pose (:mod:`vican_torch.ops.pnp`) and fetch one
   packed result buffer;
7. fill the reference edge dict (cam.py:120-124 schema).

The ``"host"`` mode replaces steps 2-3 by the host threshold
(:func:`host_threshold`: ``_native/fastthresh.c``, or its numpy stand-in
with the same bytes) on the exact frame; the kernel is not launched.  The
``"roi"`` mode keeps its JAX contract (host threshold and candidates,
detections identical to the full-frame modes) and runs the ``host``
program: the JAX package's tile upload (``ops/roi.py``) was transport for
a slow host link.  ``roi`` with the ``subpix`` refiner runs the ``device``
program, as in the JAX package.  Every mode gives the same detections for
an integral ``thresh_const`` (the default, 10); for another the host
threshold compares in float64 and the kernel in float32, as in the JAX
package.

The ``"pure"`` mode keeps the whole detection on the device
(``vican_tpu.ops.detect.detect_markers``): steps 3-4 become the
connected components, quad extraction and degenerate re-fit of
:func:`vican_torch.ops.detect.device_candidates` on the unpacked kernel
masks, and nothing but the packed result returns to the host.  Its
candidates are JAX's pure-mode candidates, which differ from the host
labeler's in tie-breaking, the row-subsampled re-fit and the dedup score
(the quad area, not the component's), so its detections can differ from
the other modes' at the edges of what decodes.  It is the mode taken when
no host labeler exists (neither the C module nor scipy).

Batches run on the JAX package's two-thread feed/drain pipeline
(vican_tpu/perception.py:1725-1758; :func:`_edges`): a worker thread
decodes, uploads, thresholds and extracts the candidates of up to
``VICAN_TPU_PIPELINE_DEPTH`` (default 2) batches ahead, on a CUDA stream of
its own, while the calling thread detects, solves PnP and fills the dict in
batch order.  The output does not depend on the depth.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh`` of
:mod:`vican_torch.parallel`) splits every batch over the ranks, one card
each; every rank returns the whole edge dict.

:func:`estimate_pose_gray` is the stage that takes gray uint8 frames;
:func:`estimate_pose_batched` decodes image files with OpenCV (imported
only when it is called) and feeds it.

Corner convention: corners are the physical marker boundary (intensity
transition midpoint), as in the JAX package.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from .cam import Camera, gen_marker_uid
from .geometry import SE3
from .utils import PhaseTimer, no_tf32, resolve_device
from .utils.registry import CORNER_REFINE, PNP_FLAGS, resolve

__all__ = [
    "estimate_pose_batched",
    "estimate_pose_gray",
    "load_images",
    "host_preprocess",
    "host_threshold",
    "host_candidates",
    "quads_from_masks",
    "quads_from_packed_masks",
    "PHASES",
]

# the per-batch phases, in order (PhaseTimer names): the device program
# runs "threshold kernel" and "masks to host", the host program "host
# threshold", the pure program "threshold kernel" and "device candidates"
# in place of the masks' fetch and "host candidates" (with its child
# "candidates upload"); "stack" (host-only) runs in estimate_pose_gray's
# loader of a sequence of frames, "decode" and "preprocess" (host-only) in
# estimate_pose_batched's, both on the feed; "wait for feed" (host-only)
# on the drain before it takes the batch
PHASES = ("stack", "decode", "preprocess", "upload", "threshold kernel", "masks to host",
          "host threshold", "host candidates", "candidates upload", "device candidates",
          "wait for feed", "detect program", "PnP", "dict")

# the host labeler that the last quads_from_masks / quads_from_packed_masks
# call ran: "c" (_native/fastccl.c) or "scipy"
last_labeler: str | None = None
# the candidates' gates and re-fit that it ran: "c" (_native/quad_gates.h,
# in the labeler's call) or "numpy" (_gated_candidates)
last_gates: str | None = None

# the C gates' re-fit branches (quad_gates.h's GateStat, in order), summed
# over every call since the caller last set them to 0: a diagnostic count,
# as a kernel wrapper's ``launches``
GATE_COUNTS = ("refits", "conn4", "widened", "clamped", "mismatch", "exhausted",
               "no_hull", "rejected", "accepted")
gate_counts: dict = dict.fromkeys(GATE_COUNTS, 0)


def load_images(filenames: Iterable[str], grayscale: bool = False) -> np.ndarray:
    """Host JPEG decode into a uint8 (B, H, W, 3) BGR batch.

    ``grayscale=True`` decodes straight to (B, H, W) gray — ~3x faster for
    JPEG (libjpeg skips chroma upsampling + the BGR round trip; measured
    8.7 -> 2.8 ms/img at 720p).  Used when brightness == contrast == 0, so
    the color->gray preprocess is the identity transform anyway.  For
    chroma-subsampled color JPEGs libjpeg's Y channel can differ by +-1
    from cvtColor(BGR2GRAY) of the color decode; every pipeline mode shares
    this loader, so cross-mode detection equality is unaffected.  The files
    decode on a pool of :func:`_host_threads` threads of its own, made and
    shut down in the call (:func:`_decode_batch`).
    """
    files = list(filenames)
    with ThreadPoolExecutor(_host_threads(len(files)), thread_name_prefix="vican-decode") as pool:
        return _decode_batch(pool, files, grayscale)


def _decode_each(pool: ThreadPoolExecutor, files: list[str], flag: int, store,
                 counts: dict | None = None) -> tuple:
    """One ``cv.imread(file, flag)`` a file on ``pool`` (it releases the
    GIL), each decoded frame handed to ``store(i, frame)`` in its own task.
    Every task ends before the call returns or raises; a file that does not
    decode raises ``FileNotFoundError`` (the first in the batch's order),
    then a batch of mixed shapes ``ValueError``.  ``counts`` (a phase's
    fields) gets ``files`` and ``workers``, the pool's threads that decoded
    them.  Returns the frames' shape."""
    import cv2 as cv

    def decode(i):
        im = cv.imread(files[i], flag)
        if im is None:
            return None, threading.get_ident()
        store(i, im)
        return im.shape, threading.get_ident()

    futs = [pool.submit(decode, i) for i in range(len(files))]
    wait(futs)
    done = [f.result() for f in futs]
    if counts is not None:
        counts["files"] = len(files)
        counts["workers"] = len({ident for _, ident in done})
    for fn, (shape, _) in zip(files, done):
        if shape is None:
            raise FileNotFoundError(f"could not read image: {fn}")
    shapes = {shape for shape, _ in done}
    if len(shapes) != 1:
        raise ValueError(
            f"mixed image shapes in batch: {shapes}. Cameras that declare "
            "resolution_x/y must match their image files; cameras with "
            "undeclared resolution are grouped by actual image size "
            "automatically (see estimate_pose_batched)."
        )
    return shapes.pop()


def _decode_batch(pool: ThreadPoolExecutor, files: list[str], grayscale: bool,
                  counts: dict | None = None) -> np.ndarray:
    """:func:`load_images` of ``files`` on ``pool`` (:func:`_decode_each`):
    each frame written into its slot of one batch that the first decoded
    frame shapes."""
    import cv2 as cv

    lock = threading.Lock()
    batch = None

    def store(i, im):
        nonlocal batch
        with lock:
            if batch is None:
                batch = np.empty((len(files), *im.shape), im.dtype)
            fits = im.shape == batch.shape[1:]
        if fits:
            batch[i] = im

    _decode_each(pool, files, cv.IMREAD_GRAYSCALE if grayscale else cv.IMREAD_COLOR, store,
                 counts)
    return batch


def _decode_gray(pool: ThreadPoolExecutor, files: list[str], table: np.ndarray, rows: slice,
                 out: np.ndarray, counts: dict | None = None) -> tuple[tuple, list]:
    """The colour decode of ``files`` on ``pool`` (:func:`_decode_each`)
    with :func:`host_preprocess`'s work done in each file's own task, on
    its pixels while they are in cache: the frames at ``rows`` (a slice of
    the batch's positions) go through ``table`` (the preprocess's 256
    bytes) in place, then ``cv.cvtColor`` BGR2GRAY straight into their row
    of ``out`` (uint8 ``(n, H, W)``, at least one row a frame), the bytes of
    ``host_preprocess(load_images(files)[rows], ...)``.  The other files
    are decoded for the batch's checks alone.  A frame of another size than
    ``out``'s rows goes into gray memory of its own.  ``counts`` gets
    ``table_frames``, the frames sent through the table.  Returns the
    frames' shape and the gray frames, in row order (views of ``out``
    where they fit)."""
    import cv2 as cv

    gray = [None] * (rows.stop - rows.start)

    def store(i, im):
        if rows.start <= i < rows.stop:
            row = out[i - rows.start] if im.shape[:2] == out.shape[1:] else None
            cv.LUT(im, table, dst=im)
            gray[i - rows.start] = cv.cvtColor(im, cv.COLOR_BGR2GRAY, dst=row)

    shape = _decode_each(pool, files, cv.IMREAD_COLOR, store, counts)
    if counts is not None:
        counts["table_frames"] = len(gray)
    return shape, gray


def _probe_image_size(fn: str) -> tuple[int, int]:
    """Actual image size ``(H, W)`` from the file header (no full decode;
    falls back to a cv2 decode when PIL is unavailable)."""
    try:
        from PIL import Image
    except ImportError:
        import cv2 as cv

        im = cv.imread(fn)
        if im is None:
            raise FileNotFoundError(f"could not read image: {fn}") from None
        return im.shape[:2]

    with Image.open(fn) as im:
        w, h = im.size
        try:
            orientation = im.getexif().get(0x0112, 1)
        except Exception:
            orientation = 1
    # cv2.imread applies EXIF orientation when decoding; 90-degree
    # orientations (5-8) swap the decoded H/W relative to the header size,
    # so the probe must match or a rotated JPEG in a resolution-less rig
    # would group under a transposed key and fail with a mixed-shape error
    if orientation in (5, 6, 7, 8):
        w, h = h, w
    return (h, w)


def _contrast_brightness(x: np.ndarray, brightness: float, contrast: float) -> np.ndarray:
    """The reference's transform, cam.py:137-145: scale and shift in
    float32, clip to [0, 255], truncate to uint8."""
    x = x.astype(np.float32)
    if contrast != 0:
        x = x * (contrast / 127.0 + 1.0) - contrast
    x = x + brightness
    return np.clip(x, 0.0, 255.0).astype(np.uint8)


def host_preprocess(images: np.ndarray, brightness: float, contrast: float,
                    counters=None, out: np.ndarray | None = None) -> np.ndarray:
    """Reference contrast/brightness + BGR grayscale, on host (uint8 out).

    Bit-matches cam.py:137-145 (:func:`_contrast_brightness`), then OpenCV
    BGR2GRAY for ``(N, H, W, 3)`` BGR input; gray ``(N, H, W)`` input
    needs no OpenCV.  On uint8 input the transform is a function of the
    byte alone, so it runs as a 256-entry table made by the same float32
    expression over every byte value: the same bytes, without the float32
    copies of the batch (~25 ms a 720p BGR frame on one core; the table
    and the gray conversion ~2 ms).  BGR frames go through ``cv.LUT`` and
    ``cv.cvtColor`` a frame at a time into one output.  Other dtypes take
    the float32 expression itself.

    ``counters``, where given, a dict that receives ``table_frames``, the
    number of frames that went through the table.  ``out``, where given, a
    uint8 ``(N, H, W)`` array that receives the gray frames and is
    returned; else the gray input itself is returned where the transform
    is the identity, and a new array otherwise.
    """
    table = None
    if contrast == 0 and brightness == 0:
        # the transform is the identity on uint8 (x + 0, clip, truncate)
        x = images
    elif images.dtype == np.uint8:
        x = images
        table = _contrast_brightness(np.arange(256, dtype=np.uint8), brightness, contrast)
    else:
        x = _contrast_brightness(images, brightness, contrast)
    if counters is not None:
        counters["table_frames"] = len(images) if table is not None else 0
    if x.ndim == 4 and x.shape[-1] == 3:
        import cv2 as cv

        out = np.empty(x.shape[:3], x.dtype) if out is None else out
        mapped = np.empty(x.shape[1:], x.dtype) if table is not None else None
        for im, o in zip(x, out):
            im = np.ascontiguousarray(im)
            if table is not None:
                im = cv.LUT(im, table, dst=mapped)
            cv.cvtColor(im, cv.COLOR_BGR2GRAY, dst=o)
        return out
    if out is None:
        return x if table is None else table[x]
    if table is None:
        np.copyto(out, x)
    else:
        np.take(table, x, out=out)
    return out


def _quad_gates(quads: np.ndarray, areas: np.ndarray, H: int, W: int, params) -> np.ndarray:
    """Vectorized candidate validity gates (same rules as ops.detect.extract_quads)."""
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
    recovers the true corners to ~1 px on these shapes.  The scipy
    labeler's path runs it, and ``_native/quad_gates.h`` is its C form
    with the same output; the decode stage remains the backstop, so a bad
    re-fit can never produce a false id.  Returns the re-fit quad (float64
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


def _get_ccl():
    from ._native import get_fastccl

    return get_fastccl()


def quads_from_masks(fg: np.ndarray, params) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Union-find quad candidates from a (B, Wn, H, W) foreground batch.

    Returns ``(quads (B, Q, 4, 2) float32, valid (B, Q) bool, areas)`` with
    ``Q = Wn * (max_candidates + max_candidates_4conn)``; quads are
    clockwise-wound and gated.  The C labeler and gates
    (:func:`quads_from_packed_masks` on the bit-packed rows) run when they
    built; otherwise the scipy.ndimage extractor below and
    :func:`_gated_candidates` reproduce them bit for bit, 4-connected
    split candidates included: both return the SAME slot layout and
    detections (vican_tpu/perception.py:303-334).
    """
    global last_labeler, last_gates
    H, W = fg.shape[2], fg.shape[3]
    if _get_ccl() is not None:
        return quads_from_packed_masks(np.packbits(fg, axis=-1, bitorder="little"), H, W,
                                       params)
    last_labeler, last_gates = "scipy", "numpy"
    return _gated_candidates(*_scipy_slots(fg, params), lambda b, wi: fg[b, wi], H, W, params)


def _candidates_scipy(fg: np.ndarray, K: int, K2: int, min_area, max_area):
    """scipy.ndimage fallback for fastccl.c — bit-identical by construction.

    Mirrors the C kernel's semantics exactly (see fastccl.c for why each
    step is tie-break-safe):

    - component numbering: ``ndimage.label`` assigns labels in raster-scan
      order of first encounter, matching the C slot order (roots keep the
      minimum run index);
    - top-K: the C ``top_k`` is replicated literally — no sort at all when
      at most K candidates pass the area filter (scan order kept), else a
      first-max selection sort whose swaps are tie-UNstable;
    - corners: the C kernel evaluates run ENDPOINTS in (y, x) scan order
      with strict comparisons; a full pixel sweep in the same order picks
      the same points because every selection metric (squared distance,
      signed cross product) is convex/linear in x along a run — an interior
      pixel can never strictly beat both endpoints, and first-max/argmax
      tie-breaking coincides;
    - splits: 4-connected components that are strict subsets of their
      8-connected parent (area4 < area8), as in quad_candidates_packed2.
    """
    from scipy import ndimage

    fg = np.ascontiguousarray(fg, dtype=np.uint8)
    lab8, n8 = ndimage.label(fg, structure=np.ones((3, 3), np.int32))
    corners = np.zeros((K + K2, 4, 2), np.float32)
    areas_out = np.zeros((K + K2,), np.int32)
    lo, hi = int(min_area), int(max_area)  # C casts both to int32

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
        # The C top_k sorts ONLY when more than K candidates pass the
        # filter (otherwise scan order is kept), and its selection sort
        # swaps (first-max, swap-unstable) — replicate both exactly.
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


def _host_threads(masks: int) -> int:
    """The threads the C labeler spreads ``masks`` (frame, window) masks
    over: the cores this process may run on, at most one a mask."""
    return max(1, min(len(os.sched_getaffinity(0)), masks))


def _c_candidates(ccl, packed: np.ndarray, H: int, W: int, params, counters=None):
    """The C labeler, winding, gates and re-fit on bit-packed
    ``(B, Wn, >=H, ceil(W/8))`` masks, every (frame, window) in ONE call
    that releases the GIL (``fastccl.quad_candidates_gated_batch``, byte for
    byte :func:`_gated_candidates` on the slots of
    ``fastccl.quad_candidates_batch``), its masks spread over
    :func:`_host_threads` threads: ``(quads, valid, areas)`` as
    :func:`quads_from_masks` returns them.  Adds its re-fit branches to
    :data:`gate_counts`, and its threads' times to ``counters``
    (:func:`quads_from_packed_masks`)."""
    B, Wn, _, Wb = packed.shape
    K, K2 = params.max_candidates, params.max_candidates_4conn
    quads = np.empty((B, Wn * (K + K2), 4, 2), np.float32)
    areas = np.empty((B, Wn * (K + K2)), np.float32)
    valid = np.empty((B, Wn * (K + K2)), bool)
    stats = np.empty(len(GATE_COUNTS), np.int64)
    times = np.empty(5, np.float64)
    t0 = time.perf_counter()
    ccl.quad_candidates_gated_batch(
        np.ascontiguousarray(packed[:, :, :H]), B, Wn, H, W, Wb, K, K2, params.min_area,
        params.max_area_rate * H * W, params.border_margin, _min_hollow_side(params),
        quads, areas, valid, stats, _host_threads(B * Wn), times)
    seconds = time.perf_counter() - t0
    for name, n in zip(GATE_COUNTS, stats.tolist()):
        gate_counts[name] += n
    if counters is not None:
        # the workers' ticks in seconds: the call's seconds on the host
        # clock over its ticks on the workers' clock
        per_tick = seconds / max(times[3], 1.0)
        counters.update(labeler_s=float(times[0]) * per_tick,
                        gates_s=float(times[1]) * per_tick, threads=int(times[2]),
                        runs=int(times[4]))
    return quads, valid, areas


def _scipy_slots(fg: np.ndarray, params):
    """The scipy labeler's slots, window by window, on unpacked
    ``(B, Wn, H, W)`` masks: ``(corners (B, Wn*Ks, 4, 2) float32, areas
    (B, Wn*Ks) int32, counts (B, Wn, 2))`` with ``Ks = K + K2`` slots a
    window and counts ``(n8, n4)``, the layout of
    ``fastccl.quad_candidates_batch``."""
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
    """The numpy tail of the scipy labeler, and the plain version of the C
    gates (``_native/quad_gates.h``): the labeler's slots
    (:func:`_scipy_slots`) -> ``(quads, valid, areas float32)``: the emitted
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


def quads_from_packed_masks(packed: np.ndarray, H: int, W: int, params, counters=None):
    """Quad candidates from bit-packed (B, Wn, H, ceil(W/8)) masks
    (little-endian bits; bits of columns >= W must be zero, as the
    threshold kernel, its plain version and :func:`host_threshold` leave
    them).

    Same output contract as :func:`quads_from_masks`, and the JAX
    package's output (vican_tpu/perception.py:496-535).  The C module
    labels, winds, gates and re-fits the whole batch in one call
    (:func:`_c_candidates`): it reads the packed rows in place, skips empty
    bytes and holds no GIL.  Without the C module the masks are unpacked
    for the scipy labeler and :func:`_gated_candidates`.

    ``counters``, where given, a dict that receives ``labeler_s`` and
    ``gates_s``, the seconds spent labeling (with the scipy labeler, the
    masks' unpacking too) and gating, summed over the threads, and
    ``threads``, how many ran: the C module's own clock on each of its
    threads, else the host clock around the two steps on one thread.  The
    C module adds ``runs``, the runs of foreground pixels it labeled over
    the batch's masks (each row's, every window's).
    """
    global last_labeler, last_gates
    ccl = _get_ccl()
    if ccl is not None:
        last_labeler, last_gates = "c", "c"
        return _c_candidates(ccl, packed, H, W, params, counters)
    t0 = time.perf_counter()
    fg = np.unpackbits(packed, axis=-1, bitorder="little")[:, :, :H, :W]
    last_labeler, last_gates = "scipy", "numpy"
    slots = _scipy_slots(fg, params)
    t1 = time.perf_counter()
    out = _gated_candidates(*slots, lambda b, wi: fg[b, wi], H, W, params)
    if counters is not None:
        counters.update(labeler_s=t1 - t0, gates_s=time.perf_counter() - t1, threads=1)
    return out


def _min_hollow_side(params) -> float:
    """The side from which a quad may pass the gates as an outline
    (:func:`_quad_gates`)."""
    return 4.0 * max(params.win_sizes)


def _get_thresh():
    from ._native import get_fastthresh

    return get_fastthresh()


def host_threshold(gray: np.ndarray, params) -> np.ndarray:
    """The multi-window adaptive threshold on the host: uint8 ``(B, H, W)``
    -> bit-packed ``(B, Wn, H, ceil(W/8))`` uint8, the layout of
    :func:`vican_torch.ops.threshold.multi_threshold`.

    The C integral-image sweep (``_native/fastthresh.c``) runs when it
    built, else :func:`_threshold_pack_numpy`; both apply the exact integer
    compare ``(g + C) win^2 <= boxsum`` for an integral ``thresh_const``
    (the default, 10), which is the device kernel's float32 test on every
    pixel, so the masks are the kernel's byte for byte.  A non-integral C
    is compared in float64 here and in float32 on the card, as in the JAX
    package (vican_tpu/perception.py:568-626), and may differ on ties.
    """
    B, H, W = gray.shape
    wins = tuple(int(w) for w in params.win_sizes)
    th = _get_thresh()
    packed = np.empty((B, len(wins), H, -(-W // 8)), np.uint8)
    for b in range(B):
        g = np.ascontiguousarray(gray[b])
        if th is not None:
            buf = th.threshold_pack(g, H, W, wins, float(params.thresh_const))
            packed[b] = np.frombuffer(buf, np.uint8).reshape(packed.shape[1:])
        else:
            packed[b] = _threshold_pack_numpy(g, wins, params.thresh_const)
    return packed


def host_candidates(gray: np.ndarray, params) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-threshold path: :func:`host_threshold` then
    :func:`quads_from_packed_masks` on a uint8 ``(B, H, W)`` batch, as the
    ``host`` and ``roi`` modes run it."""
    _, H, W = gray.shape
    return quads_from_packed_masks(host_threshold(gray, params), H, W, params)


def _threshold_pack_numpy(g: np.ndarray, wins, C) -> np.ndarray:
    """numpy stand-in for fastthresh.c, identical masks by construction.

    One replicate-padded int32 integral image sweeps every window size;
    an integral C takes the same exact integer compare
    ``(g + C) * win^2 <= boxsum`` (see fastthresh.c for why it equals the
    device kernel's float32 test), another C the float64 test of
    fastthresh.c.
    """
    H, W = g.shape
    R = max(w // 2 for w in wins)
    gp = np.pad(g, R, mode="edge").astype(np.int32)
    ii = np.zeros((H + 2 * R + 1, W + 2 * R + 1), np.int32)
    np.cumsum(np.cumsum(gp, axis=0), axis=1, out=ii[1:, 1:])
    out = np.empty((len(wins), H, -(-W // 8)), np.uint8)
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
        out[wi] = np.packbits(fg, axis=1, bitorder="little")
    return out


def _pnp_block(det, Ks, dists, marker_size, lm_iters, pnp_method):
    """Detections -> one packed float64 ``(B*D, 23)`` result: corners (8),
    id, ok, R (9), t (3), reprojection error, as
    vican_tpu/perception.py:_pnp_block packs them
    (:func:`vican_torch.ops.pnp.pnp_block`: one kernel launch on the card,
    no host sync)."""
    from .ops.pnp import pnp_block

    B, D = det.ids.shape
    return pnp_block(det.corners.reshape(B * D, 4, 2).contiguous(),
                     det.ids.reshape(B * D).contiguous(), det.valid.reshape(B * D).contiguous(),
                     Ks.contiguous(), dists.contiguous(), marker_size, lm_iters, pnp_method)


def _unpack_pnp_result(out: np.ndarray):
    """Host inverse of :func:`_pnp_block`'s ``(N, 23)`` buffer: ``(corners
    (N, 4, 2), ids, ok, R (N, 3, 3), t (N, 3), err)``."""
    N = out.shape[0]
    return (out[:, 0:8].reshape(N, 4, 2), out[:, 8].astype(np.int64), out[:, 9] > 0.5,
            out[:, 10:19].reshape(N, 3, 3), out[:, 19:22], out[:, 22])


def _batch_memory(shape, dev: torch.device, like=None) -> torch.Tensor:
    """Empty uint8 memory for a batch of ``shape`` bound for ``dev``: on
    the card that holds ``like`` (a frame or batch) where it is on one, so
    frames on a card never pass through the host; else host memory,
    page-locked where ``dev`` is a CUDA card.  The page-locked memory comes
    from PyTorch's caching host allocator.  A block is resident, so the
    frames written into it meet no page fault, and it reaches the card by
    DMA without a bounce through CUDA's own staging buffer
    (:func:`_upload`).  The allocator hands a block out again only once the
    copies queued from it have run, so a batch is never rewritten before
    its upload ends; and it keeps its blocks, so a few serve batch after
    batch and call after call.  The process holds them until it exits:
    each block is the batch's bytes rounded up to a power of two (32
    frames: 16 MiB at 640x480, 32 MiB at 1280x720, 64 MiB at 1920x1080),
    a few blocks a batch size (PERF.md, section 3, gives the count).  On
    the CPU the memory is plain."""
    if isinstance(like, torch.Tensor) and like.is_cuda:
        return torch.empty(shape, dtype=torch.uint8, device=like.device)
    return torch.empty(shape, dtype=torch.uint8, pin_memory=dev.type == "cuda")


def _pad(batch: torch.Tensor, m: int) -> torch.Tensor:
    """``batch`` with copies of its row ``m - 1`` written into its rows
    from ``m`` on (a tail batch's pad)."""
    if m < len(batch):
        batch[m:] = batch[m - 1]
    return batch


def _assemble(frames, out: torch.Tensor) -> torch.Tensor:
    """Write ``frames`` (an ``(m, H, W)`` array or tensor, or a sequence of
    m 2-D frames, ``m <= len(out)``) into ``out``'s first m rows and copies
    of the last of them into the rest, and return ``out``."""
    m = len(frames)
    if isinstance(frames, (list, tuple)):
        torch.stack([torch.as_tensor(f) for f in frames], out=out[:m])
    else:
        out[:m].copy_(torch.as_tensor(frames))
    return _pad(out, m)


def _upload(gray, n: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The batch of ``n`` frames made from ``gray`` (a loader's: ``n``
    frames, or fewer, padded to ``n`` with copies of the last) on ``dev``,
    and the host batch it was copied from (None where ``gray`` was on a
    card).  Host frames bound for a card are first assembled in
    :func:`_batch_memory`'s page-locked memory, unless they are a whole
    batch there already, then copied without blocking on the calling
    thread's current stream.  Frames on a card, and host frames bound for
    the CPU, are taken as they are, and assembled only to be padded."""
    on_card = isinstance(gray, torch.Tensor) and gray.is_cuda
    staged = (on_card or dev.type != "cuda"
              or (isinstance(gray, torch.Tensor) and gray.is_pinned()))
    if len(gray) < n or not staged:
        gray = _assemble(gray, _batch_memory((n, *gray.shape[1:]), dev, gray))
    gray = torch.as_tensor(gray)
    if on_card:
        return gray.to(dev).contiguous(), None
    return gray.to(dev, non_blocking=True).contiguous(), gray


@dataclass
class _Fed:
    """One batch as the feed stage hands it to the drain: the meta data of
    its frames, the frames ``g`` on the device, the cameras' intrinsics and
    distortions on the device, ``candidates`` (``(quads, valid, areas)``:
    tensors on the card, which the host modes' gated arrays are moved to
    on the feed; on the CPU, the host modes' numpy arrays), and ``ready``,
    a CUDA event on the feed's stream after its last device work (None on
    the CPU)."""

    files: list
    cams: list
    nb: int
    g: torch.Tensor
    Ks: torch.Tensor
    dists: torch.Tensor
    candidates: tuple
    ready: object = None


class _Fetched:
    """A tensor on its way to the host (the packed masks, the packed
    ``(B*D, 23)`` PnP result): on the card, a non-blocking copy into
    pinned memory on the calling thread's current stream and the CUDA event
    after it, so :meth:`numpy` waits for that stream alone; on the CPU,
    the tensor itself."""

    def __init__(self, out: torch.Tensor):
        self.event = None
        if out.is_cuda:
            self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(out.device))
        else:
            self.host = out

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _Program:
    """The per-batch program for one configuration: ``mode`` ``"device"``
    (threshold kernel on the card, packed masks to the host), ``"host"``
    (host threshold on the exact frame) or ``"pure"`` (threshold kernel and
    candidates on the card); detect and PnP are shared
    (vican_tpu/perception.py:1158-1182, 1420-1681).  :meth:`feed` runs on
    the pipeline's worker thread and :meth:`drain` on the calling thread
    (:func:`_edges`)."""

    def __init__(self, mode, aruco, marker_size, corner_refine, flags, lm_iters,
                 detector_params, device):
        from .ops import detect as D_
        from .ops.dictionary import get_dictionary, marker_bits_table

        if device.type == "cuda" and device.index is None:
            # the worker thread enters this device: its own current device
            # is cuda:0, and under mesh= a rank's card need not be
            device = torch.device("cuda", torch.cuda.current_device())
        self.mode = mode
        self.device = device
        self.marker_size = float(marker_size)
        self.lm_iters = lm_iters
        self.pnp_method = resolve(PNP_FLAGS, flags, "flags")
        _, self.n_bits = get_dictionary(aruco)
        self.codes = D_.dictionary_codes(marker_bits_table(aruco), device)
        params = detector_params or D_.DetectorParams()
        params = params._replace(corner_refine=resolve(CORNER_REFINE, corner_refine,
                                                       "corner_refine"))
        self.params = D_.resolve_error_correction(params, aruco)

    def feed(self, files, cams, nb, gray, timer: PhaseTimer) -> _Fed:
        """The feed stage of one batch (uint8 gray ``(B, H, W)`` as given,
        or fewer frames, padded to one a camera with copies of the last):
        upload (:func:`_upload`: the "upload" event counts the frames'
        ``height``, ``width`` and ``bytes``, and ``pinned``, 1 where they
        went through page-locked memory), threshold, and the host candidates
        (:func:`quads_from_packed_masks`: labeler, winding, gates and
        re-fit, then on the card their upload; the host modes) or the
        device candidates (``pure``).  On the
        card it runs on the caller's current stream, the feed's own
        (:func:`_edges`).  The "host candidates" event counts the
        labeler's and the gates' thread-seconds (``labeler_s``,
        ``gates_s``), the ``threads`` that ran, the ``runs`` the C labeler
        labeled and the valid ``candidates`` slots, which the drain's
        detect program takes in;
        its child "candidates upload" times their move to the card (on the
        CPU, nothing).  "detect program" and "PnP" record
        ``device_seconds``; the feed's phases record no timing events.

        The host candidates run here whole because the C module's one call
        a batch holds no GIL.  The numpy gates of a host without the C
        module hold it, and there convoy with the drain on the GIL, as they
        did on the card when they ran here beside PnP's launch loop."""
        from .ops import detect as D_
        from .ops.threshold import multi_threshold

        p, dev = self.params, self.device
        H, W = gray.shape[1:]
        Ks, dists = _camera_arrays(cams)
        with timer.phase("upload", stage="feed") as counts:
            g, host = _upload(gray, len(cams), dev)
            counts.update(height=H, width=W, bytes=g.numel(),
                          pinned=int(host is not None and g.is_cuda))
            Ks_d = torch.as_tensor(Ks, dtype=torch.float64).to(dev)
            dists_d = torch.as_tensor(dists, dtype=torch.float64).to(dev)
        if self.mode == "pure":
            with timer.phase("threshold kernel", stage="feed"):
                packed = multi_threshold(g, p.win_sizes, p.thresh_const)
            with timer.phase("device candidates", stage="feed"):
                candidates = D_.device_candidates(D_.unpack_masks(packed, W), p)
                del packed
        else:
            if self.mode == "device":
                with timer.phase("threshold kernel", stage="feed"):
                    packed = multi_threshold(g, p.win_sizes, p.thresh_const)
                with timer.phase("masks to host", stage="feed"):
                    packed = _Fetched(packed).numpy()
            else:
                with timer.phase("host threshold", stage="feed"):
                    host = g.cpu() if host is None else host
                    packed = host_threshold(host.numpy(), p)
            with timer.phase("host candidates", stage="feed") as counts:
                candidates = quads_from_packed_masks(packed, H, W, p, counts)
                counts["candidates"] = int(np.count_nonzero(candidates[1]))
                with timer.phase("candidates upload", stage="feed"):
                    if g.is_cuda:
                        # on the feed's stream, which the masks' fetch left
                        # idle: the drain's detect program then waits on
                        # nothing but the feed's event
                        candidates = tuple(torch.as_tensor(c).to(dev) for c in candidates)
        ready = None
        if g.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        return _Fed(files, cams, nb, g, Ks_d, dists_d, candidates, ready)

    def drain(self, fed: _Fed, timer: PhaseTimer) -> _Fetched:
        """The drain stage of one batch on the calling thread's current
        stream: wait for the feed's event, then
        refine, decode and dedup the candidates over the resident frames
        (:func:`vican_torch.ops.detect.detect_candidates`), solve PnP, and
        start the packed result's fetch."""
        from .ops import detect as D_

        if fed.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(fed.ready)
            # the tensors the feed made on its stream are read on this one:
            # the caching allocator must not hand their memory back to the
            # feed before this stream's work on them is done
            for t in (fed.g, fed.Ks, fed.dists, *fed.candidates):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(stream)
        with timer.phase("detect program", stage="drain", device_time=True):
            det = D_.detect_candidates(fed.g, *fed.candidates, self.codes, self.n_bits,
                                       self.params)
        with timer.phase("PnP", stage="drain", device_time=True):
            out = _pnp_block(det, fed.Ks, fed.dists, self.marker_size, self.lm_iters,
                             self.pnp_method)
        return _Fetched(out)


def _camera_arrays(cams):
    Ks = np.stack([np.asarray(c.intrinsics, np.float64) for c in cams])
    dists = np.stack([np.pad(np.atleast_1d(c.distortion).astype(np.float64), (0, 14))[:14]
                      for c in cams])
    return Ks, dists


def _has_host_ccl() -> bool:
    """The hybrid modes need a host component labeler: the C module
    (fastccl.c) or the bit-identical scipy.ndimage stand-in."""
    if _get_ccl() is not None:
        return True
    try:
        import scipy.ndimage  # noqa: F401

        return True
    except ImportError:
        return False


def _resolve_mode(pipeline_mode: str) -> str:
    """``pipeline_mode`` as requested -> ``"device"``, ``"host"``, ``"roi"``
    or ``"pure"`` (vican_tpu/perception.py:1197-1211, without its
    environment override).  ``"auto"`` is ``"device"`` here: on the card the
    threshold kernel takes a fraction of a millisecond per batch, where the
    host threshold costs milliseconds a frame.  Without a host labeler a
    hybrid mode falls back to ``"pure"`` with a warning, as in JAX."""
    if pipeline_mode not in ("auto", "roi", "device", "host", "pure"):
        raise ValueError(f"unknown perception pipeline mode: {pipeline_mode!r}")
    mode = "device" if pipeline_mode == "auto" else pipeline_mode
    if mode != "pure" and not _has_host_ccl():
        import warnings

        warnings.warn("no host component labeler (fastccl/scipy); "
                      "falling back to the pure-device path")
        return "pure"
    return mode


def _program_mode(mode: str, corner_refine: str) -> str:
    """The program a resolved mode runs: ``"roi"`` runs the ``"host"``
    program, but with the ``subpix`` refiner the ``"device"`` one
    (vican_tpu/perception.py:1285-1290: cornerSubPix samples without bound,
    so the JAX package's ROI contract cannot hold for it)."""
    if mode == "roi":
        subpix = resolve(CORNER_REFINE, corner_refine, "corner_refine") == "subpix"
        return "device" if subpix else "host"
    return mode


def _pipeline_depth() -> int:
    """Batches in flight on the feed side: ``VICAN_TPU_PIPELINE_DEPTH``,
    default 2 (0 or unset), at least 1 (vican_tpu/perception.py:1737-1739)."""
    return max(1, int(os.environ.get("VICAN_TPU_PIPELINE_DEPTH") or 2) or 2)


def _share(nb: int, lo: int, n: int) -> slice:
    """The frames of a batch of ``nb`` that make the ``n`` rows from row
    ``lo`` of it padded with copies of its last frame: the real frames
    there and the last one where the rows run past them (the whole share
    being its copies where ``lo >= nb``)."""
    return slice(min(lo, nb - 1), min(lo + n, nb))


def _edges(load, batches: list, B, program: _Program, timer: PhaseTimer, verbose: bool,
           part=(0, 1)) -> tuple[dict, list]:
    """Run batches through ``program`` on the two-thread feed/drain
    pipeline of vican_tpu/perception.py:1725-1758.  ``batches`` holds
    each batch's frame indices, ``len <= B``.  A tail batch is padded to
    ``B`` frames with copies of its last frame and camera
    (vican_tpu/perception.py:1343-1345) and only its ``nb`` real frames
    enter the dict.  ``part = (rank, world)``: this process runs only the
    rank's ``B / world`` rows of every padded batch.  ``load(idx, share)``
    returns batch ``idx``'s ``(files, cams, gray)``: its files and
    cameras, and in ``gray`` (uint8, ``(n, H, W)``) its frames
    ``idx[share]`` (:func:`_share`), the rank's own, either as they are
    or as the rank's whole padded batch, ready for the upload
    (:func:`_batch_memory`, :func:`_assemble`).  It runs on the feed
    thread, on the feed's stream.  Returns the dict and its keys batch by
    batch.

    The feed (one worker thread, :func:`_pipeline_depth` batches in flight)
    loads each batch (decodes files: cv2 releases the GIL; stacks frames
    into page-locked memory), uploads it,
    thresholds it and finds its candidates (:meth:`_Program.feed`).  The
    calling thread drains in batch order (:meth:`_Program.drain`): detect
    and PnP, then batch i's result enters the dict after
    batch i+1's detection was launched (JAX's ``pending_d``).  Where this
    departs from JAX's split: JAX labels on the main thread (``stage_ccl``,
    vican_tpu/perception.py:1437-1461), which overlaps the device's work
    because its detection program is dispatched asynchronously.  Here
    detect and PnP are eager, and their host launch loop IS the dispatch,
    so the host candidates run on the worker to overlap with them; the C
    labeler with its gates and the host threshold release the GIL
    (``_native``).

    Threads and streams.  On the card the worker enters the program's
    device (the caller's, which under ``mesh=`` need not be ``cuda:0``) and
    a stream of its own: on the shared default stream the masks' fetch
    would queue behind the drain's PnP.  The feed stream first waits for
    the caller's stream (frames the caller queued on the card); the
    loader runs on it too, so a stack of frames on the card is ordered
    before the upload and threshold that read it.  The drain
    waits on each batch's event and records the feed's tensors on its own
    stream (:meth:`_Program.drain`).  :class:`PhaseTimer` synchronizes the
    calling thread's stream only, so the stages do not wait for each
    other's kernels; its events carry ``stage`` ``"feed"`` or ``"drain"``,
    ``batch`` (the batch's index, set on each thread by
    :meth:`PhaseTimer.in_batch`: every feed and drain event of a batch
    shares it) and ``parent`` (the phase open around it on its own thread,
    which the timer keeps per thread, as the two stages nest theirs at
    once).  The drain's host-only "wait for feed" phase is the time it
    waits for the feed to hand over the batch: where it is long, the feed
    sets the rate.  The "dict" event counts the batch's ``detections``.
    On the CPU all stream handling is skipped and the same two threads
    run.  The worker writes ``multi_threshold.launches``,
    :data:`last_labeler`, :data:`last_gates` and :data:`gate_counts`,
    which read as after an in-order run once the call returns.

    Order and errors.  The dict is filled in batch order and, within a
    batch, slot order, whatever the depth.  An exception in either stage
    is raised by the call; the batches not yet started are cancelled.
    With depth d, up to d + 1 batches are resident (d fed, one draining).
    """
    out: dict = {}
    order: list = []
    rank, world = part
    Bs = B // world
    Dcap = program.params.max_detections
    dev = program.device
    depth = _pipeline_depth()
    total = 0
    feed_stream = None
    if dev.type == "cuda":
        feed_stream = torch.cuda.Stream(dev)
        feed_stream.wait_stream(torch.cuda.current_stream(dev))

    def feed(bi, idx) -> _Fed:
        nb, lo = len(idx), rank * Bs
        with timer.in_batch(bi), contextlib.ExitStack() as on_feed_stream:
            if feed_stream is not None:
                on_feed_stream.enter_context(torch.cuda.device(dev))
                on_feed_stream.enter_context(torch.cuda.stream(feed_stream))
            files, cams, gray = load(idx, _share(nb, lo, Bs))
            cams = [cams[min(r, nb - 1)] for r in range(lo, lo + Bs)]
            return program.feed(files[lo:lo + Bs], cams, max(0, min(nb - lo, Bs)), gray, timer)

    def consume(bi, files, cams, nb, fetched: _Fetched):
        nonlocal total
        keys = []
        with timer.phase("dict", stage="drain") as counts:
            corners, ids, ok, R, t, err = _unpack_pnp_result(fetched.numpy())
            counts["detections"] = int(np.count_nonzero(ok[: nb * Dcap]))
            for j in range(nb):
                for k in range(Dcap):
                    e = j * Dcap + k
                    if not ok[e]:
                        continue
                    key = (cams[j].id, gen_marker_uid(files[j], str(int(ids[e]))))
                    out[key] = {
                        "pose": SE3(R=R[e], t=t[e]),
                        "corners": corners[e].copy(),
                        "reprojected_err": float(err[e]),
                        "im_filename": files[j],
                    }
                    keys.append(key)
                    total += 1
        order.append(keys)
        if verbose:
            print(f"  batch {bi}: {nb} images, {counts['detections']} detections")

    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="vican-feed")
    try:
        futs = deque(ex.submit(feed, bi, idx) for bi, idx in enumerate(batches[:depth]))
        pending = None
        for bi in range(len(batches)):
            with timer.in_batch(bi):
                with timer.phase("wait for feed", stage="drain", host_only=True):
                    fed = futs.popleft().result()
                if bi + depth < len(batches):
                    futs.append(ex.submit(feed, bi + depth, batches[bi + depth]))
                fetched = program.drain(fed, timer)
            if pending is not None:
                with timer.in_batch(pending[0]):
                    consume(*pending)
            pending = (bi, fed.files, fed.cams, fed.nb, fetched)
            del fed  # its frames and candidates, once the drain's stream is done
        if pending is not None:
            with timer.in_batch(pending[0]):
                consume(*pending)
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    if verbose:
        n_images = len({v["im_filename"] for v in out.values()})
        print(f"Found markers in {n_images} images ({total} detections).")
    return out, order


def _gather_edges(mesh, out: dict, order: list) -> dict:
    """Every rank's edges, merged on every rank in the order of a run on
    one card: batch by batch, and within a batch rank by rank (the ranks
    hold consecutive frames)."""
    import torch.distributed as dist

    from .parallel.sharded import _group

    group, _, world, _ = _group(mesh)
    parts = [None] * world
    dist.all_gather_object(parts, (out, order), group=group)
    merged: dict = {}
    for bi in range(len(order)):
        for part_out, part_order in parts:
            for key in part_order[bi]:
                merged[key] = part_out[key]
    return merged


def _group_batches(keys, B: int) -> list:
    """The frames' indices batch by batch: grouped by ``keys`` (a frame
    size each), the groups in first-seen order, each ``B`` at a time."""
    groups: dict = {}
    for i, key in enumerate(keys):
        groups.setdefault(key, []).append(i)
    return [idx[s:s + B] for idx in groups.values() for s in range(0, len(idx), B)]


def estimate_pose_gray(
    gray,
    im_filenames: list[str],
    cams: list[Camera],
    aruco: str,
    marker_size: float,
    corner_refine: str,
    flags: str,
    batch_size: int = 32,
    lm_iters: int = 20,
    detector_params=None,
    device=None,
    verbose: bool = True,
    timer: PhaseTimer | None = None,
    pipeline_mode: str = "auto",
) -> dict:
    """Perception from preprocessed gray frames, with one file name and one
    camera per frame -> the reference edge dict.  The file names only name
    the detections (``"<parent dir>_<marker>"``, :func:`gen_marker_uid`).

    ``gray``: uint8 ``(N, H, W)`` (a numpy array or a tensor on any
    device), whose batches are slices of it; or a sequence of 2-D uint8
    frames (numpy arrays or tensors) of any mix of sizes, as a rig of
    several camera models decodes them.  The sequence's frames are grouped
    by size, groups in first-seen order, and every group's batches run in
    turn through one pipeline; the feed stacks each batch from its frames
    (host-only phase "stack", counters ``height``, ``width``, ``frames``).
    The dict is the union of one call per size.

    ``pipeline_mode``: ``"auto"`` (= ``"device"``), ``"device"``,
    ``"host"``, ``"roi"`` (these give the same detections) or ``"pure"``
    (module docstring).  ``device=None`` is the CUDA card (raises without
    one).  ``timer`` collects the per-batch phases (:data:`PHASES`)."""
    mode = _resolve_mode(pipeline_mode)
    device = resolve_device(device)
    no_tf32()
    im_filenames, cams = list(im_filenames), list(cams)
    if not (len(gray) == len(im_filenames) == len(cams)):
        raise ValueError("estimate_pose_gray: one file name and one camera per frame")
    program = _Program(_program_mode(mode, corner_refine), aruco, marker_size,
                       corner_refine, flags, lm_iters, detector_params, device)
    timer = timer or PhaseTimer(verbose=False, device=device)
    B = batch_size

    array = isinstance(gray, (np.ndarray, torch.Tensor))
    if array:
        sizes = [tuple(gray.shape[1:])] * len(gray)
    else:
        gray = [torch.as_tensor(f) for f in gray]
        for i, f in enumerate(gray):
            if f.dim() != 2 or f.dtype != torch.uint8:
                raise ValueError(f"estimate_pose_gray: frame {i} is {f.dtype} of shape "
                                 f"{tuple(f.shape)}, not a 2-D uint8 frame")
        sizes = [tuple(f.shape) for f in gray]

    def load(idx, share):
        """One batch: an array's slice (its batches are contiguous), which
        the upload assembles; or one stack of a sequence's frames into the
        batch's memory, pad and all (:func:`_assemble`)."""
        files, bcams = [im_filenames[i] for i in idx], [cams[i] for i in idx]
        ids = idx[share]
        if array:
            return files, bcams, gray[ids[0]:ids[-1] + 1]
        with timer.phase("stack", stage="feed", host_only=True) as counts:
            frames = [gray[i] for i in ids]
            batch = _assemble(frames, _batch_memory((B, *frames[0].shape), device, frames[0]))
            counts.update(height=batch.shape[1], width=batch.shape[2], frames=len(idx))
        return files, bcams, batch

    return _edges(load, _group_batches(sizes, B), B, program, timer, verbose)[0]


def estimate_pose_batched(
    im_filenames: list[str],
    cams: list[Camera],
    aruco: str,
    marker_size: float,
    corner_refine: str,
    brightness: int,
    contrast: int,
    flags: str,
    batch_size: int = 32,
    lm_iters: int = 20,
    detector_params=None,
    mesh=None,
    pipeline_mode: str = "auto",
    verbose: bool = True,
    device=None,
    timer: PhaseTimer | None = None,
) -> dict:
    """Run the perception pipeline over image files (JPEG decode and the
    reference's brightness/contrast/gray preprocess on the host with
    OpenCV, then the batches of :func:`estimate_pose_gray`).

    ``pipeline_mode``: ``"auto"`` (= ``"device"``), ``"device"``,
    ``"host"``, ``"roi"`` or ``"pure"`` (module docstring).  ``mesh``: a
    ``DeviceMesh`` of :mod:`vican_torch.parallel` (anything else raises
    ``TypeError``), called on every rank: the batch is rounded up to a
    multiple of the ranks, each rank decodes every batch and runs its share
    of it on its own card, and every rank returns the whole dict, in the
    order of a run on one card (vican_tpu/perception.py:1302-1321).
    Cameras of different resolutions are grouped, as in the JAX package,
    groups in first-seen order, and every group's batches run in turn
    through one pipeline: the dict is the union of one call per group.
    The feed decodes a batch's files on a pool of :func:`_host_threads`
    threads that the call makes and shuts down; with a brightness or a
    contrast each task also sends its file through the preprocess's table
    and to gray, into the batch's memory (:func:`_decode_gray`; else
    :func:`_decode_batch` decodes straight to gray).  The "decode" phase
    counts its ``files``, ``workers`` and ``table_frames`` (the frames
    transformed in the tasks: the rank's share, or 0); "preprocess" pads
    the batch and counts the same ``table_frames``.
    Returns the reference edge dict.
    """
    mode = _resolve_mode(pipeline_mode)
    world = 1
    if mesh is not None:
        from .parallel.sharded import _group

        _, rank, world, _ = _group(mesh)
    device = resolve_device(device)
    no_tf32()

    res_of = lambda c: (getattr(c, "resolution_y", None), getattr(c, "resolution_x", None))
    res_keys = [res_of(c) for c in cams]
    if any(None in r for r in res_keys):
        res_keys = [r if None not in r else _probe_image_size(fn)
                    for r, fn in zip(res_keys, im_filenames)]
    if verbose and len(set(res_keys)) > 1:
        for (h, w), n in Counter(res_keys).items():
            print(f"Resolution group {w}x{h}: {n} images")

    program = _Program(_program_mode(mode, corner_refine), aruco, marker_size,
                       corner_refine, flags, lm_iters, detector_params, device)
    timer = timer or PhaseTimer(verbose=False, device=device)
    B = -(-batch_size // world) * world
    gray_direct = float(brightness) == 0.0 and float(contrast) == 0.0
    table = _contrast_brightness(np.arange(256, dtype=np.uint8), float(brightness),
                                 float(contrast))

    def load(idx, share):
        """Decode, check and preprocess one batch (JAX's ``prepare``,
        vican_tpu/perception.py:1325-1363); runs on the feed thread, its
        files decoded on ``pool``.  Colour files (a brightness or contrast)
        are decoded, sent through the preprocess's table and converted to
        gray in each file's task, the rank's share straight into the
        batch's memory (:func:`_decode_gray`, :func:`_batch_memory`, made
        here at the group's size), which "preprocess" then pads.  Gray
        files are handed on as decoded, the rank's share of them, for the
        upload to assemble."""
        files, bcams = [im_filenames[i] for i in idx], [cams[i] for i in idx]
        if gray_direct:
            with timer.phase("decode", stage="feed", host_only=True) as counts:
                images = _decode_batch(pool, files, True, counts)
                counts["table_frames"] = 0
            shape = images.shape[1:]
        else:
            gray = _batch_memory((B // world, *map(int, res_keys[idx[0]])), device)
            with timer.phase("decode", stage="feed", host_only=True) as counts:
                shape, frames = _decode_gray(pool, files, table, share, gray.numpy(), counts)
        decl = res_of(bcams[0])
        if None not in decl and tuple(shape[:2]) != decl:
            raise ValueError(
                f"camera {bcams[0].id!r} declares resolution "
                f"{decl[1]}x{decl[0]} but {files[0]!r} decodes to "
                f"{shape[1]}x{shape[0]} — fix the camera "
                "record, or leave resolution_x/y as None to group by "
                "actual image size"
            )
        if gray_direct:
            return files, bcams, images[share]
        with timer.phase("preprocess", stage="feed", host_only=True) as counts:
            counts["table_frames"] = len(frames)
            if tuple(shape[:2]) == tuple(gray.shape[1:]):
                _pad(gray, len(frames))
            else:  # the size probed from the files' headers is not the decoded one
                gray = _assemble(frames, _batch_memory((len(gray), *shape[:2]), device))
        return files, bcams, gray

    batches = _group_batches(res_keys, B)
    with ThreadPoolExecutor(_host_threads(B), thread_name_prefix="vican-decode") as pool:
        if mesh is None:
            return _edges(load, batches, B, program, timer, verbose)[0]
        out, order = _edges(load, batches, B, program, timer, verbose, part=(rank, world))
    return _gather_edges(mesh, out, order)
