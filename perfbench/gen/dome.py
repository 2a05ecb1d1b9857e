"""The dome scene, made from the seed: a rig of two camera models around the cube.

The CMU Panoptic Studio's layout (Joo et al., TPAMI 2019): one geodesic
dome whose panels hold ``vga_per_panel`` VGA cameras each, and
``hd_cameras`` HD cameras between them, all on a sphere of
``dome_radius`` about the ``target`` and all looking at it, where the
upstream's 24-marker cube (:mod:`perfbench.gen.scene`: its markers, tiles
and trajectory) tumbles.  Panels and HD cameras lie on golden-angle
spirals over the elevations ``elevation_deg``; a panel's cameras on a
grid of ``panel_span_deg``.  Cameras are named as the studio names them,
``<panel>_<node>``, the HD cameras in panel 00.

:func:`render` draws every (timestep, camera) view as
:func:`perfbench.gen.scene.render_image` does, byte for byte
(``perfbench/tests/test_perfbench_rig.py``), but with every frame of a
frame size and a draw rank in one set of tensor operations: the per-marker
loop of ``render_image`` costs ~20 ms a frame on the card, which 4,088
frames could not afford in a run's set-up.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference.pnp import homography_4pt, pad_distortion, project_points
from .scene import cube_markers, cube_trajectory, inverse, look_at, marker_tiles

GOLDEN = np.pi * (3.0 - np.sqrt(5.0))
# pixels a chunk of frames holds while a draw rank is composited: ~2 GB of
# float32 and int64 temporaries on the card
CHUNK_PIXELS = 1 << 24
BACKGROUND = 170  # render_image's


def _spiral(n: int, elevation_deg, phase: float = 0.0) -> list:
    """``n`` (azimuth, elevation) pairs in radians spread evenly over the
    band of elevations: equal areas of the sphere, golden-angle turns."""
    lo, hi = np.sin(np.radians(elevation_deg[0])), np.sin(np.radians(elevation_deg[1]))
    return [(phase + k * GOLDEN, float(np.arcsin(lo + (hi - lo) * (k + 0.5) / n)))
            for k in range(n)]


def cameras(config: dict) -> list:
    """The dome's cameras in the order their frames arrive (by azimuth
    around the dome, VGA and HD interleaved): ``id``, ``K`` (f =
    ``focal_rate`` (W + H)), ``dist`` (the configuration's distortion on
    every ``distorted_every``-th camera of each model, else none), ``W``,
    ``H`` and ``extrinsics`` (camera->world), looking at ``target``."""
    target = np.asarray(config["target"], float)
    r = config["dome_radius"]

    def cam(cid, az, el, res, k):
        W, H = res
        f = config["focal_rate"] * (W + H)
        K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
        dist = np.asarray(config["distortion"], float)
        if k % config["distorted_every"] != 1:
            dist = np.zeros(len(dist))
        pos = target + r * np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
        return dict(id=cid, K=K, dist=dist, W=W, H=H, extrinsics=look_at(pos, target),
                    azimuth=float(az % (2 * np.pi)))

    out = []
    span_az, span_el = np.radians(config["panel_span_deg"])
    cols, rows = config["panel_grid"]
    if cols * rows != config["vga_per_panel"]:
        raise ValueError("perfbench: panel_grid does not hold vga_per_panel cameras")
    for p, (az, el) in enumerate(_spiral(config["panels"], config["elevation_deg"])):
        for n in range(config["vga_per_panel"]):
            i, j = n % cols, n // cols
            out.append(cam(f"{p + 1:02d}_{n + 1:02d}",
                           az + span_az * ((i + 0.5) / cols - 0.5) / np.cos(el),
                           el + span_el * ((j + 0.5) / rows - 0.5),
                           config["vga_resolution"], n))
    for n, (az, el) in enumerate(_spiral(config["hd_cameras"], config["elevation_deg"],
                                         phase=GOLDEN / 2)):
        out.append(cam(f"00_{n:02d}", az, el, config["hd_resolution"], n))
    return sorted(out, key=lambda c: c["azimuth"])


def _draw_list(cam: dict, marker_world: dict, tiles: dict, marker_size: float) -> list:
    """``render_image``'s painter's list for one view: ``(tile id, Hinv
    float32 (3, 3), x0, x1, y0, y1)`` of each marker it draws, far to
    near, by its arithmetic."""
    W, H = cam["W"], cam["H"]
    K = torch.as_tensor(np.asarray(cam["K"], np.float64))[None]
    dist = pad_distortion(torch.as_tensor(np.asarray(cam["dist"], np.float64)))[None]
    cam_inv = inverse(cam["extrinsics"]).astype(np.float32)
    h = marker_size / 2.0
    corners_m = np.array([[-h, h, 0], [h, h, 0], [h, -h, 0], [-h, -h, 0]])
    seen, pts = [], []
    for mid, pose_w in marker_world.items():
        pc = (cam_inv @ pose_w).astype(np.float64)
        Rmc, tmc = pc[:3, :3], pc[:3, 3]
        if tmc[2] <= 0.05 or np.dot(Rmc[:, 2], tmc) >= 0:
            continue
        pts_c = corners_m @ Rmc.T + tmc
        if (pts_c[:, 2] <= 0.05).any():
            continue
        seen.append(mid)
        pts.append(pts_c)
    if not seen:
        return []
    n = len(seen)
    pts_t = torch.as_tensor(np.stack(pts))
    eye = torch.eye(3, dtype=torch.float64).expand(n, 3, 3)
    proj = project_points(pts_t, eye, torch.zeros(n, 3, dtype=torch.float64),
                          K.expand(n, 3, 3), dist.expand(n, 14))
    draw = []
    for mid, p, pc in zip(seen, proj.numpy(), pts):
        if (p[:, 0] < -50).all() or (p[:, 0] > W + 50).all():
            continue
        draw.append((pc[:, 2].mean(), mid, p))
    draw.sort(key=lambda x: -x[0])
    if not draw:
        return []
    N = tiles[draw[0][1]].shape[0]
    src = torch.tensor([[-0.5, -0.5], [N - 0.5, -0.5], [N - 0.5, N - 0.5], [-0.5, N - 0.5]],
                       dtype=torch.float64)
    Hm = homography_4pt(src, torch.as_tensor(np.stack([p for _, _, p in draw])))
    reach = torch.tensor([[-1.0, -1.0], [N, -1.0], [N, N], [-1.0, N]], dtype=torch.float64)
    reach = torch.cat([reach, torch.ones(4, 1, dtype=torch.float64)], 1)
    Hinv = torch.linalg.inv(Hm).to(torch.float32)
    out = []
    for k, (_, mid, _) in enumerate(draw):
        ext = reach @ Hm[k].T
        ext = (ext[:, :2] / ext[:, 2:]).numpy()
        x0, x1 = max(int(np.floor(ext[:, 0].min())), 0), min(int(np.ceil(ext[:, 0].max())) + 1, W)
        y0, y1 = max(int(np.floor(ext[:, 1].min())), 0), min(int(np.ceil(ext[:, 1].max())) + 1, H)
        if x0 < x1 and y0 < y1:
            out.append((mid, Hinv[k], x0, x1, y0, y1))
    return out


def _warp(tiles, M, xs, ys):
    """``scene._warp_tile`` over whole frames: tile ``tiles (n, N, N)``
    float32 through ``M (n, 3, 3)`` float32 at every pixel ``(xs (W,),
    ys (H,))`` float32 -> ``(n, H, W)``."""
    N = tiles.shape[1]
    m = [[M[:, i, j, None, None] for j in range(3)] for i in range(3)]
    x, y = xs[None, None, :], ys[None, :, None]
    w = m[2][0] * x + m[2][1] * y + m[2][2]
    sx = (m[0][0] * x + m[0][1] * y + m[0][2]) / w
    sy = (m[1][0] * x + m[1][1] * y + m[1][2]) / w
    fx, fy = torch.floor(sx), torch.floor(sy)
    a, b = sx - fx, sy - fy
    x0, y0 = fx.long(), fy.long()
    n = torch.arange(tiles.shape[0], device=tiles.device)[:, None, None]

    def at(yy, xx):
        inside = (yy >= 0) & (yy < N) & (xx >= 0) & (xx < N)
        return tiles[n, yy.clamp(0, N - 1), xx.clamp(0, N - 1)] * inside

    p00, p01, p10, p11 = at(y0, x0), at(y0, x0 + 1), at(y0 + 1, x0), at(y0 + 1, x0 + 1)
    top = p00 + a * (p01 - p00)
    bottom = p10 + a * (p11 - p10)
    return torch.round(top + b * (bottom - top)).clamp(0, 255)


def render_views(views: list, W: int, H: int, tiles: dict, device) -> list:
    """Frames ``(H, W)`` uint8 numpy, one a view, from each view's
    :func:`_draw_list`: chunks of frames, a draw rank at a time, each
    marker composited inside its box as ``render_image`` composites it."""
    ids = sorted(tiles)
    slot = {m: i for i, m in enumerate(ids)}
    tile_t = torch.as_tensor(np.stack([tiles[m] for m in ids])).to(device).to(torch.float32)
    ones = torch.full_like(tile_t[:1], 255.0)
    xs = torch.arange(W, device=device, dtype=torch.float32)
    ys = torch.arange(H, device=device, dtype=torch.float32)
    step = max(1, CHUNK_PIXELS // (W * H))
    out = []
    for c0 in range(0, len(views), step):
        chunk = views[c0:c0 + step]
        img = torch.full((len(chunk), H, W), BACKGROUND, dtype=torch.uint8, device=device)
        for rank in range(max((len(v) for v in chunk), default=0)):
            rows = [j for j, v in enumerate(chunk) if len(v) > rank]
            items = [chunk[j][rank] for j in rows]
            M = torch.stack([it[1] for it in items]).to(device)
            box = torch.tensor([it[2:] for it in items], device=device)
            inside = ((xs[None, None, :] >= box[:, 0, None, None])
                      & (xs[None, None, :] < box[:, 1, None, None])
                      & (ys[None, :, None] >= box[:, 2, None, None])
                      & (ys[None, :, None] < box[:, 3, None, None]))
            sel = torch.tensor(rows, device=device)
            warped = _warp(tile_t[torch.tensor([slot[it[0]] for it in items], device=device)],
                           M, xs, ys)
            alpha = _warp(ones.expand(len(items), -1, -1), M, xs, ys) / 255.0
            patch = img[sel].to(torch.float32)
            new = torch.clamp(patch * (1 - alpha) + warped * alpha, 0, 255).to(torch.uint8)
            img[sel] = torch.where(inside, new, img[sel])
        out.extend(f.copy() for f in img.cpu().numpy())
    return out


def render(config: dict, seed: int, device):
    """Every (timestep, camera) view of the dome's capture for ``seed``,
    timesteps outer and the cameras of a timestep in :func:`cameras`'
    order: ``(frames [(H, W) uint8 numpy], names ["<t>/<cam>.jpg"],
    camera index of each frame, cameras)``."""
    cams = cameras(config)
    markers = cube_markers(config["cube_size"])
    tiles = marker_tiles(list(markers), config["marker_px"])
    traj = cube_trajectory(config["timesteps"], seed, tuple(config["target"]), config["wander"])
    views, names, cam_of = [], [], []
    for t, obj in enumerate(traj):
        world = {m: (obj @ mp).astype(np.float32) for m, mp in markers.items()}
        for ci, cam in enumerate(cams):
            views.append(_draw_list(cam, world, tiles, config["marker_size"]))
            names.append(f"{t}/{cam['id']}.jpg")
            cam_of.append(ci)
    frames = [None] * len(views)
    for W, H in sorted({(c["W"], c["H"]) for c in cams}):
        idx = [i for i, ci in enumerate(cam_of) if (cams[ci]["W"], cams[ci]["H"]) == (W, H)]
        for i, f in zip(idx, render_views([views[i] for i in idx], W, H, tiles, device)):
            frames[i] = f
    return frames, names, cam_of, cams
