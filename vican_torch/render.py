"""Synthetic marker-scene renderer in PyTorch, on any device.

The port of the rasterizer in ``vican_tpu.render``: an ArUco-marker cube
seen by a static camera network.  The JAX package renders with OpenCV on
the host (``projectPoints``, ``getPerspectiveTransform``,
``warpPerspective``, ``fillConvexPoly``) and writes JPEGs; this module
renders the same scenes as tensors, so a machine without OpenCV can make
its own frames on the card:

- :func:`render_image`  -- one camera view, uint8 gray ``(H, W)``;
- :func:`render_frames` -- every (timestep, camera) view of a trajectory as
  one uint8 batch, the loop of ``vican_tpu.render.render_dataset`` without
  the JPEG write;
- :func:`render_dataset` -- the Dataset-layout directory of JPEGs (OpenCV
  writes them, imported only there), the frames rendered on ``device``.

:func:`boxes_intersect`, :func:`cams_seeing` and :func:`cube_pose_candidate`
are the scene generators' host-side placement tests, copied as they are.

Marker corners are projected through :func:`vican_torch.ops.pnp.
project_points` in float64 (the full 12-coefficient distortion model); each
marker is an inverse bilinear warp of its bitmap over its projected
bounding box only, composited in painter's order.  The warp follows the
float32 scheme of OpenCV 5.0's ``cv.warpPerspective`` for 8-bit images, but
not its exact arithmetic: a few edge pixels differ by one grey level
(tests/test_torch_perception.py states the agreement).  Occluder faces are
filled without anti-aliasing.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .geometry import SE3, rodrigues
from .ops.pnp import homography_4pt, pad_distortion, project_points
from .utils import resolve_device

__all__ = [
    "make_cube_markers",
    "look_at",
    "marker_tiles",
    "render_image",
    "render_frames",
    "render_dataset",
    "cube_trajectory",
    "boxes_intersect",
    "cams_seeing",
    "cube_pose_candidate",
]


def make_cube_markers(
    aruco: str = "DICT_4X4_1000",
    cube_size: float = 0.575,
    markers_per_face: int = 4,
    marker_ratio: float = 0.38,
    ids=None,
) -> dict:
    """Marker poses on a cube: ``{marker_id: SE3 marker->object}``.

    ``markers_per_face`` in {1, 4}: one centered marker or a 2x2 grid per
    face.  Marker frame: x right, y up in the marker plane, z out of the
    face.  The datasets' cube carries 24 markers (render.py:467-469).
    """
    h = cube_size / 2.0
    faces = [
        (np.array([0, 0, 1.0]), np.array([1.0, 0, 0]), np.array([0, 1.0, 0])),
        (np.array([0, 0, -1.0]), np.array([-1.0, 0, 0]), np.array([0, 1.0, 0])),
        (np.array([1.0, 0, 0]), np.array([0, 0, -1.0]), np.array([0, 1.0, 0])),
        (np.array([-1.0, 0, 0]), np.array([0, 0, 1.0]), np.array([0, 1.0, 0])),
        (np.array([0, 1.0, 0]), np.array([1.0, 0, 0]), np.array([0, 0, -1.0])),
        (np.array([0, -1.0, 0]), np.array([1.0, 0, 0]), np.array([0, 0, 1.0])),
    ]
    if markers_per_face == 1:
        offsets = [(0.0, 0.0)]
    elif markers_per_face == 4:
        q = cube_size / 4.0
        offsets = [(-q, -q), (q, -q), (-q, q), (q, q)]
    else:
        raise ValueError("markers_per_face must be 1 or 4")
    out = {}
    mid = 0
    for normal, ex, ey in faces:
        for ox, oy in offsets:
            R = np.stack([ex, ey, normal], axis=1)
            t = normal * h + ex * ox + ey * oy
            out[str(ids[mid]) if ids is not None else str(mid)] = SE3(R=R, t=t)
            mid += 1
    return out


def look_at(position, target, up=(0, 0, 1.0)) -> SE3:
    """Camera extrinsics (camera->world) looking from ``position`` at
    ``target``; OpenCV camera convention: +z forward, +x right, +y down."""
    position = np.asarray(position, float)
    fwd = np.asarray(target, float) - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, float))
    if np.linalg.norm(right) < 1e-9:
        right = np.cross(fwd, np.array([0, 1.0, 0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return SE3(R=np.stack([right, down, fwd], axis=1), t=position)


def boxes_intersect(c_a, half_a, R_a, c_b, half_b, R_b) -> bool:
    """Oriented-box overlap by the separating-axis theorem, over 15
    candidate axes (3 + 3 face normals, 9 edge cross products); the
    reference tests mesh overlap in Blender (render.py:164-205)."""
    c_a, c_b = np.asarray(c_a, float), np.asarray(c_b, float)
    half_a, half_b = np.asarray(half_a, float), np.asarray(half_b, float)
    R_a, R_b = np.asarray(R_a, float), np.asarray(R_b, float)
    d = c_b - c_a
    axes = [R_a[:, i] for i in range(3)] + [R_b[:, i] for i in range(3)]
    for i in range(3):
        for j in range(3):
            cr = np.cross(R_a[:, i], R_b[:, j])
            n = np.linalg.norm(cr)
            if n > 1e-9:
                axes.append(cr / n)
    for ax in axes:
        ra = np.sum(half_a * np.abs(ax @ R_a))
        rb = np.sum(half_b * np.abs(ax @ R_b))
        if abs(ax @ d) > ra + rb:
            return False
    return True


def cams_seeing(cams: dict, point, distance_cutoff: float = 7.0) -> list:
    """Camera ids whose view contains ``point``: in front of the camera,
    projecting inside the image, closer than ``distance_cutoff`` (the
    reference's visibility test, render.py:348-371, 374-390)."""
    point = np.asarray(point, float)
    seen = []
    for cid, cam in cams.items():
        pc = cam.extrinsics.inv().apply(point.reshape(3, 1)).ravel()
        if pc[2] <= 0.05 or np.linalg.norm(pc) > distance_cutoff:
            continue
        K = np.asarray(cam.intrinsics, float)
        u = K[0, 0] * pc[0] / pc[2] + K[0, 2]
        v = K[1, 1] * pc[1] / pc[2] + K[1, 2]
        if 0 <= u < cam.resolution_x and 0 <= v < cam.resolution_y:
            seen.append(cid)
    return seen


def cube_pose_candidate(
    rng: np.random.Generator,
    cams: dict,
    region_low,
    region_high,
    *,
    cube_size: float = 0.575,
    keep_out=(),
    min_views: int = 2,
    distance_cutoff: float = 7.0,
    max_tries: int = 200,
) -> SE3 | None:
    """An accepted object pose, as the reference's scene generators draw
    it (render.py:297-371): uniform position in ``[region_low,
    region_high]`` and uniform random rotation, redrawn until the cube
    avoids every keep-out box (``(center, half_sizes)`` or ``(center,
    half_sizes, R)``) and its center is in view of at least ``min_views``
    cameras within ``distance_cutoff``.  None after ``max_tries`` draws."""
    lo = np.asarray(region_low, float)
    hi = np.asarray(region_high, float)
    half = np.full(3, cube_size / 2.0)
    for _ in range(max_tries):
        pos = rng.uniform(lo, hi)
        v = rng.normal(size=3)
        v = v / max(np.linalg.norm(v), 1e-12) * rng.uniform(0.0, np.pi)
        R = rodrigues(v)
        if any(boxes_intersect(pos, half, R, box[0], box[1],
                               box[2] if len(box) > 2 else np.eye(3)) for box in keep_out):
            continue
        if len(cams_seeing(cams, pos, distance_cutoff)) < min_views:
            continue
        return SE3(R=R, t=pos)
    return None


def marker_tiles(marker_ids, aruco: str = "DICT_4X4_1000", marker_px: int = 120) -> dict:
    """``{marker_id: uint8 bitmap}``: the dictionary pattern inside a black
    border cell, each cell ``marker_px // (n + 2)`` pixels
    (vican_tpu/render.py:342-352)."""
    from .ops.dictionary import get_dictionary

    bits, n = get_dictionary(aruco)
    cells = n + 2
    scale = max(marker_px // cells, 1)
    out = {}
    for mid in marker_ids:
        tile = np.zeros((cells, cells), np.uint8)
        tile[1:-1, 1:-1] = bits[int(mid)] * 255
        out[mid] = np.kron(tile, np.ones((scale, scale), np.uint8))
    return out


def cube_trajectory(n_frames: int, seed: int, target=(0.0, 0.0, 1.0),
                    wander: bool = False) -> dict:
    """``{str(t): SE3 object->world}``: the cube tumbling at ``target``
    (uniform random rotations; ``wander=True`` adds the positional jitter),
    drawn as ``vican_tpu.synthetic.render_cube_scene`` draws it."""
    rng = np.random.default_rng(seed)
    traj = {}
    for t in range(n_frames):
        v = rng.normal(size=3)
        v = v / np.linalg.norm(v) * rng.uniform(0.0, np.pi)
        if wander:
            pos = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5),
                            target[2] + rng.uniform(-0.3, 0.3)])
        else:
            pos = np.asarray(target, float)
        traj[str(t)] = SE3(R=rodrigues(v), t=pos)
    return traj


def _warp_tile(tile: torch.Tensor, Hinv: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Inverse bilinear warp of ``tile (N, N)`` uint8 at destination pixels
    ``(xs, ys)``, zero outside the tile, as OpenCV 5.0's
    ``cv.warpPerspective`` computes it for 8-bit images: the inverse
    homography in float32, exact float32 bilinear weights, rounded to the
    nearest grey level (uint8 values as float32)."""
    N = tile.shape[0]
    M = Hinv.to(torch.float32)
    x, y = xs.to(torch.float32), ys.to(torch.float32)
    w = M[2, 0] * x + M[2, 1] * y + M[2, 2]
    sx = (M[0, 0] * x + M[0, 1] * y + M[0, 2]) / w
    sy = (M[1, 0] * x + M[1, 1] * y + M[1, 2]) / w
    fx, fy = torch.floor(sx), torch.floor(sy)
    a, b = sx - fx, sy - fy
    x0, y0 = fx.long(), fy.long()
    t = tile.to(torch.float32)

    def at(yy, xx):
        inside = (yy >= 0) & (yy < N) & (xx >= 0) & (xx < N)
        return t[yy.clamp(0, N - 1), xx.clamp(0, N - 1)] * inside

    p00, p01, p10, p11 = at(y0, x0), at(y0, x0 + 1), at(y0 + 1, x0), at(y0 + 1, x0 + 1)
    top = p00 + a * (p01 - p00)
    bottom = p10 + a * (p11 - p10)
    return torch.round(top + b * (bottom - top)).clamp(0, 255)


def _fill_convex(img: torch.Tensor, poly: np.ndarray, shade: int) -> None:
    """Set the pixels whose centers lie in the convex polygon ``poly
    (P, 2)`` (integer vertices) to ``shade``, in place."""
    H, W = img.shape
    x0, y0 = max(int(poly[:, 0].min()), 0), max(int(poly[:, 1].min()), 0)
    x1, y1 = min(int(poly[:, 0].max()) + 1, W), min(int(poly[:, 1].max()) + 1, H)
    if x0 >= x1 or y0 >= y1:
        return
    dev = img.device
    ys, xs = torch.meshgrid(torch.arange(y0, y1, device=dev, dtype=torch.float64),
                            torch.arange(x0, x1, device=dev, dtype=torch.float64), indexing="ij")
    P = poly.astype(np.float64)
    E = np.roll(P, -1, axis=0) - P
    sign = np.sign(np.sum(P[:, 0] * np.roll(P[:, 1], -1) - np.roll(P[:, 0], -1) * P[:, 1]))
    inside = torch.ones_like(xs, dtype=torch.bool)
    for (px, py), (ex, ey) in zip(P, E):
        inside &= sign * (ex * (ys - py) - ey * (xs - px)) >= 0
    img[y0:y1, x0:x1][inside] = shade


def render_image(cam, marker_world: dict, marker_images: dict, marker_size: float,
                 background: int = 170, occluders=(), device=None) -> torch.Tensor:
    """Rasterize markers (and occluder boxes) into one camera image: uint8
    gray ``(H, W)`` on ``device`` (``None``: the CUDA card, which must
    exist; the JAX package returns the same image as three BGR channels).

    ``marker_world``: {id: SE3 marker->world}; ``marker_images``: {id:
    uint8 square bitmap} (:func:`marker_tiles`); ``occluders``: ``(SE3
    box->world, half_sizes)`` gray boxes.  One painter's list of marker
    quads and box faces, drawn far to near (vican_tpu/render.py:190-297).
    """
    dev = resolve_device(device)
    W, H = cam.resolution_x, cam.resolution_y
    K = torch.as_tensor(np.asarray(cam.intrinsics, np.float64))[None]
    dist = np.zeros(12) if cam.distortion is None else np.asarray(cam.distortion, np.float64)
    dist = pad_distortion(torch.as_tensor(np.atleast_1d(dist)))[None]
    cam_inv = cam.extrinsics.inv()
    h = marker_size / 2.0
    corners_m = np.array([[-h, h, 0], [h, h, 0], [h, -h, 0], [-h, -h, 0]])

    def project(pts_c):
        eye = torch.eye(3, dtype=torch.float64)[None]
        return project_points(torch.as_tensor(pts_c), eye, torch.zeros(1, 3, dtype=torch.float64),
                              K, dist)[0].numpy()

    draw_list = []  # (mean depth, kind, payload)
    for mid, pose_w in marker_world.items():
        pc = cam_inv @ pose_w  # marker -> camera
        Rmc, tmc = np.asarray(pc.R(), float), np.asarray(pc.t(), float)
        if tmc[2] <= 0.05 or np.dot(Rmc[:, 2], tmc) >= 0:  # behind, or facing away
            continue
        pts_c = corners_m @ Rmc.T + tmc
        if (pts_c[:, 2] <= 0.05).any():
            continue
        proj = project(pts_c)
        if (proj[:, 0] < -50).all() or (proj[:, 0] > W + 50).all():
            continue
        draw_list.append((pts_c[:, 2].mean(), "marker", (mid, proj)))

    hx = np.array([[1, 1, -1, -1, 1, 1, -1, -1],
                   [1, -1, -1, 1, 1, -1, -1, 1],
                   [1, 1, 1, 1, -1, -1, -1, -1]], float).T
    face_idx = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
                (2, 3, 7, 6), (1, 2, 6, 5), (3, 0, 4, 7)]
    for pose_w, half in occluders:
        pc = cam_inv @ pose_w
        Rb, tb = np.asarray(pc.R(), float), np.asarray(pc.t(), float)
        corners_c = (hx * np.asarray(half, float)) @ Rb.T + tb
        for f in face_idx:
            pts_c = corners_c[list(f)]
            if (pts_c[:, 2] <= 0.05).any():
                continue
            n = np.cross(pts_c[1] - pts_c[0], pts_c[3] - pts_c[0])
            if np.dot(n, pts_c.mean(axis=0)) >= 0:
                n = -n
            shade = int(np.clip(90 + 60 * abs(n[2]) / max(np.linalg.norm(n), 1e-9), 0, 255))
            draw_list.append((pts_c[:, 2].mean(), "face", (project(pts_c), shade)))

    img = torch.full((H, W), background, dtype=torch.uint8, device=dev)
    for _, kind, payload in sorted(draw_list, key=lambda x: -x[0]):
        if kind == "face":
            proj, shade = payload
            _fill_convex(img, np.round(proj).astype(np.int64), shade)
            continue
        mid, proj = payload
        N = marker_images[mid].shape[0]
        # the continuous marker square spans [-0.5, N - 0.5] in source pixel
        # centers; the physical boundary lands exactly on `proj`
        src = torch.tensor([[-0.5, -0.5], [N - 0.5, -0.5], [N - 0.5, N - 0.5], [-0.5, N - 0.5]],
                           dtype=torch.float64)
        Hm = homography_4pt(src, torch.as_tensor(proj)[None])[0]
        # every destination pixel with a nonzero weight maps into (-1, N)
        reach = torch.tensor([[-1.0, -1.0], [N, -1.0], [N, N], [-1.0, N]], dtype=torch.float64)
        ext = torch.cat([reach, torch.ones(4, 1, dtype=torch.float64)], 1) @ Hm.T
        ext = (ext[:, :2] / ext[:, 2:]).numpy()
        x0, x1 = max(int(np.floor(ext[:, 0].min())), 0), min(int(np.ceil(ext[:, 0].max())) + 1, W)
        y0, y1 = max(int(np.floor(ext[:, 1].min())), 0), min(int(np.ceil(ext[:, 1].max())) + 1, H)
        if x0 >= x1 or y0 >= y1:
            continue
        Hinv = torch.linalg.inv(Hm).to(dev)
        ys, xs = torch.meshgrid(torch.arange(y0, y1, device=dev, dtype=torch.float64),
                                torch.arange(x0, x1, device=dev, dtype=torch.float64),
                                indexing="ij")
        tile = torch.as_tensor(marker_images[mid]).to(dev)
        warped = _warp_tile(tile, Hinv, xs, ys)
        alpha = _warp_tile(torch.full_like(tile, 255), Hinv, xs, ys) / 255.0
        patch = img[y0:y1, x0:x1].to(torch.float32)
        img[y0:y1, x0:x1] = torch.clamp(patch * (1 - alpha) + warped * alpha, 0, 255).to(torch.uint8)
    return img


def render_frames(cams: dict, traj: dict, markers: dict, aruco: str = "DICT_4X4_1000",
                  marker_size: float = 0.48 * 0.575 / 2, marker_px: int = 120,
                  occluders=(), device=None):
    """Every (timestep, camera) view of ``traj`` ({t: SE3 object->world})
    for ``cams`` ({id: Camera}) and ``markers`` ({id: SE3 marker->object}),
    in ``render_dataset``'s order (timesteps outer, cameras inner).

    Returns ``(frames (T*C, H, W) uint8 on device, im_filenames
    ["<t>/<cam_id>.jpg"], frame_cams)``: the names and cameras the
    perception stage takes with the frames.  ``device=None`` is the CUDA
    card, as for every entry point of the port."""
    tiles = marker_tiles(list(markers), aruco, marker_px)
    frames, names, frame_cams = [], [], []
    for t, obj_pose in traj.items():
        marker_world = {m: obj_pose @ mp for m, mp in markers.items()}
        for cid, cam in cams.items():
            frames.append(render_image(cam, marker_world, tiles, marker_size,
                                       occluders=occluders, device=device))
            names.append(f"{t}/{cid}.jpg")
            frame_cams.append(cam)
    return torch.stack(frames), names, frame_cams


def render_dataset(
    root: str,
    cams: dict,
    obj_traj: dict,
    marker_poses: dict,
    aruco: str = "DICT_4X4_1000",
    marker_size: float = 0.48 * 0.575 / 2,
    marker_px: int = 120,
    jpeg_quality: int = 95,
    occluders=(),
    shard: tuple | None = None,
    resume: bool = False,
    only_visible_cams: bool = False,
    distance_cutoff: float = 7.0,
    device=None,
) -> None:
    """Write a Dataset-layout directory (vican_tpu/render.py:300-410):
    ``cameras.json``, ``object_pose_<core>.json`` and ``<t>/<cam_id>.jpg``.

    ``cams``: {cam_id: Camera}; ``obj_traj``: {t: SE3 object->world};
    ``marker_poses``: {marker_id: SE3 marker->object}; ``occluders``:
    ``(SE3, half_sizes)`` boxes for :func:`render_image`.  Frames are
    rendered on ``device`` (``None``: the CUDA card) and written by OpenCV
    as 3-channel JPEGs at ``jpeg_quality``.

    - ``shard=(core_id, num_cores)``: only the timesteps with ``index %
      num_cores == core_id``, their poses in ``object_pose_<core_id>.json``
      (the reference's render farm, render.py:491-519);
    - ``resume=True``: reload an existing pose file and skip the timesteps
      whose images exist (render.py:506-515);
    - ``only_visible_cams``: render only the cameras that see the object
      center (render.py:374-390).

    The pose file is flushed every 25 timesteps, so a killed process
    resumes from the last flush.
    """
    import cv2 as cv

    os.makedirs(root, exist_ok=True)
    tiles = marker_tiles(list(marker_poses), aruco, marker_px)

    cams_json = {}
    for cid, cam in cams.items():
        K = np.asarray(cam.intrinsics, float)
        cams_json[cid] = {
            "fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2],
            "distortion": (
                np.zeros(12) if cam.distortion is None
                else np.atleast_1d(np.asarray(cam.distortion, float))
            ).tolist(),
            "R": np.asarray(cam.extrinsics.R(), float).tolist(),
            "t": np.asarray(cam.extrinsics.t(), float).tolist(),
            "resolution_x": cam.resolution_x,
            "resolution_y": cam.resolution_y,
        }
    with open(os.path.join(root, "cameras.json"), "w") as f:
        json.dump(cams_json, f)

    core_id, num_cores = shard if shard is not None else (0, 1)
    pose_file = os.path.join(root, f"object_pose_{core_id}.json")
    obj_json = {}
    if resume and os.path.exists(pose_file):
        with open(pose_file) as f:
            obj_json = json.load(f)

    for i, (t, obj_pose) in enumerate(obj_traj.items()):
        if i % num_cores != core_id:
            continue
        visible = (cams_seeing(cams, obj_pose.t(), distance_cutoff)
                   if only_visible_cams else list(cams))
        tdir = os.path.join(root, str(t))
        if resume and str(t) in obj_json and all(
                os.path.exists(os.path.join(tdir, f"{cid}.jpg")) for cid in visible):
            continue
        obj_json[str(t)] = {
            "R": np.asarray(obj_pose.R(), float).tolist(),
            "t": np.asarray(obj_pose.t(), float).tolist(),
        }
        marker_world = {m: obj_pose @ mp for m, mp in marker_poses.items()}
        os.makedirs(tdir, exist_ok=True)
        for cid in visible:
            gray = render_image(cams[cid], marker_world, tiles, marker_size,
                                occluders=occluders, device=device).cpu().numpy()
            cv.imwrite(os.path.join(tdir, f"{cid}.jpg"), np.repeat(gray[..., None], 3, axis=-1),
                       [cv.IMWRITE_JPEG_QUALITY, jpeg_quality])
        if len(obj_json) % 25 == 0:
            with open(pose_file, "w") as f:
                json.dump(obj_json, f)
    with open(pose_file, "w") as f:
        json.dump(obj_json, f)
