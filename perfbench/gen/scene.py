"""The room scene, made from the seed: a frozen copy of the port's renderer.

A tumbling cube of 24 ArUco markers seen by a ring of static cameras, as
``vican_torch.render`` draws it (``make_cube_markers``, ``look_at``,
``cube_trajectory``, ``marker_tiles``, ``render_image``, ``render_frames``
without occluders), in plain numpy and torch with 4x4 matrices in place of
the port's pose type.  The same configuration and seed give the port's
frames byte for byte (``perfbench/tests/test_perfbench_harness.py``), so
a later change to the port's renderer cannot change what is measured.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference.dictionary import marker_bits
from ..reference.pnp import homography_4pt, pad_distortion, project_points


def rodrigues(vec) -> np.ndarray:
    """Axis-angle vector -> 3x3 rotation (closed form)."""
    vec = np.asarray(vec, dtype=np.float64).reshape(3)
    theta = np.linalg.norm(vec)
    if theta < 1e-12:
        return np.eye(3)
    k = vec / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def pose(R, t) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = R
    out[:3, 3] = np.asarray(t, float).reshape(3)
    return out


def inverse(T: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=T.dtype)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def cube_markers(cube_size: float = 0.575) -> dict:
    """``{marker id: marker->object 4x4}``: a 2x2 grid of markers on each
    face of the cube, ids 0-23 in face order."""
    h = cube_size / 2.0
    faces = [
        (np.array([0, 0, 1.0]), np.array([1.0, 0, 0]), np.array([0, 1.0, 0])),
        (np.array([0, 0, -1.0]), np.array([-1.0, 0, 0]), np.array([0, 1.0, 0])),
        (np.array([1.0, 0, 0]), np.array([0, 0, -1.0]), np.array([0, 1.0, 0])),
        (np.array([-1.0, 0, 0]), np.array([0, 0, 1.0]), np.array([0, 1.0, 0])),
        (np.array([0, 1.0, 0]), np.array([1.0, 0, 0]), np.array([0, 0, -1.0])),
        (np.array([0, -1.0, 0]), np.array([1.0, 0, 0]), np.array([0, 0, 1.0])),
    ]
    q = cube_size / 4.0
    offsets = [(-q, -q), (q, -q), (-q, q), (q, q)]
    out, mid = {}, 0
    for normal, ex, ey in faces:
        for ox, oy in offsets:
            out[str(mid)] = pose(np.stack([ex, ey, normal], axis=1), normal * h + ex * ox + ey * oy)
            mid += 1
    return out


def look_at(position, target, up=(0, 0, 1.0)) -> np.ndarray:
    """Camera->world 4x4 looking from ``position`` at ``target`` (+z
    forward, +x right, +y down)."""
    position = np.asarray(position, float)
    fwd = np.asarray(target, float) - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, float))
    if np.linalg.norm(right) < 1e-9:
        right = np.cross(fwd, np.array([0, 1.0, 0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return pose(np.stack([right, down, fwd], axis=1), position)


def cube_trajectory(n_frames: int, seed: int, target=(0.0, 0.0, 1.0), wander=True) -> list:
    """Object->world 4x4 of each timestep: uniform random rotations,
    positions jittered about ``target`` when ``wander``."""
    rng = np.random.default_rng(seed)
    traj = []
    for _ in range(n_frames):
        v = rng.normal(size=3)
        v = v / np.linalg.norm(v) * rng.uniform(0.0, np.pi)
        if wander:
            pos = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5),
                            target[2] + rng.uniform(-0.3, 0.3)])
        else:
            pos = np.asarray(target, float)
        traj.append(pose(rodrigues(v), pos))
    return traj


def marker_tiles(marker_ids, marker_px: int = 120) -> dict:
    """``{marker id: uint8 bitmap}``: the pattern inside a black border cell."""
    bits = marker_bits()
    n = bits.shape[1]
    cells = n + 2
    scale = max(marker_px // cells, 1)
    out = {}
    for mid in marker_ids:
        tile = np.zeros((cells, cells), np.uint8)
        tile[1:-1, 1:-1] = bits[int(mid)] * 255
        out[mid] = np.kron(tile, np.ones((scale, scale), np.uint8))
    return out


def _warp_tile(tile, Hinv, xs, ys):
    """Inverse bilinear warp of ``tile`` at destination pixels, float32
    weights, rounded to grey levels, zero outside the tile."""
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


def render_image(cam: dict, marker_world: dict, tiles: dict, marker_size: float, device,
                 background: int = 170) -> torch.Tensor:
    """One camera view, uint8 ``(H, W)`` on ``device``: the markers warped
    far to near.  ``cam``: ``K``, ``dist``, ``extrinsics`` (camera->world),
    ``W``, ``H``."""
    W, H = cam["W"], cam["H"]
    K = torch.as_tensor(np.asarray(cam["K"], np.float64))[None]
    dist = pad_distortion(torch.as_tensor(np.asarray(cam["dist"], np.float64)))[None]
    # the port's pose type rounds every composed pose to float32
    cam_inv = inverse(cam["extrinsics"]).astype(np.float32)
    h = marker_size / 2.0
    corners_m = np.array([[-h, h, 0], [h, h, 0], [h, -h, 0], [-h, -h, 0]])
    draw = []
    for mid, pose_w in marker_world.items():
        pc = (cam_inv @ pose_w).astype(np.float64)
        Rmc, tmc = pc[:3, :3], pc[:3, 3]
        if tmc[2] <= 0.05 or np.dot(Rmc[:, 2], tmc) >= 0:
            continue
        pts_c = corners_m @ Rmc.T + tmc
        if (pts_c[:, 2] <= 0.05).any():
            continue
        eye = torch.eye(3, dtype=torch.float64)[None]
        proj = project_points(torch.as_tensor(pts_c), eye, torch.zeros(1, 3, dtype=torch.float64),
                              K, dist)[0].numpy()
        if (proj[:, 0] < -50).all() or (proj[:, 0] > W + 50).all():
            continue
        draw.append((pts_c[:, 2].mean(), mid, proj))
    img = torch.full((H, W), background, dtype=torch.uint8, device=device)
    for _, mid, proj in sorted(draw, key=lambda x: -x[0]):
        N = tiles[mid].shape[0]
        src = torch.tensor([[-0.5, -0.5], [N - 0.5, -0.5], [N - 0.5, N - 0.5], [-0.5, N - 0.5]],
                           dtype=torch.float64)
        Hm = homography_4pt(src, torch.as_tensor(proj)[None])[0]
        reach = torch.tensor([[-1.0, -1.0], [N, -1.0], [N, N], [-1.0, N]], dtype=torch.float64)
        ext = torch.cat([reach, torch.ones(4, 1, dtype=torch.float64)], 1) @ Hm.T
        ext = (ext[:, :2] / ext[:, 2:]).numpy()
        x0, x1 = max(int(np.floor(ext[:, 0].min())), 0), min(int(np.ceil(ext[:, 0].max())) + 1, W)
        y0, y1 = max(int(np.floor(ext[:, 1].min())), 0), min(int(np.ceil(ext[:, 1].max())) + 1, H)
        if x0 >= x1 or y0 >= y1:
            continue
        Hinv = torch.linalg.inv(Hm).to(device)
        ys, xs = torch.meshgrid(torch.arange(y0, y1, device=device, dtype=torch.float64),
                                torch.arange(x0, x1, device=device, dtype=torch.float64),
                                indexing="ij")
        tile = torch.as_tensor(tiles[mid]).to(device)
        warped = _warp_tile(tile, Hinv, xs, ys)
        alpha = _warp_tile(torch.full_like(tile, 255), Hinv, xs, ys) / 255.0
        patch = img[y0:y1, x0:x1].to(torch.float32)
        img[y0:y1, x0:x1] = torch.clamp(patch * (1 - alpha) + warped * alpha, 0, 255).to(torch.uint8)
    return img


def cameras(config: dict) -> list:
    """The ring of cameras a room configuration states: ``cameras`` of
    them at radius ``radius[0]`` to ``radius[1]``, heights ``height`` +-
    ``height_swing``, all looking at ``target``; f = ``focal_rate`` (W + H);
    the cameras in ``distorted`` with the configuration's distortion."""
    W, H = config["resolution"]
    f = config["focal_rate"] * (W + H)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    n = config["cameras"]
    r0, r1 = config["radius"]
    out = []
    for k in range(n):
        az, r = 2 * np.pi * k / n, r0 + (r1 - r0) * k / (n - 1)
        pos = (r * np.cos(az), r * np.sin(az), config["height"] + config["height_swing"] * (-1) ** k)
        dist = (np.asarray(config["distortion"], float) if str(k) in config["distorted"]
                else np.zeros(len(config["distortion"])))
        out.append(dict(id=str(k), K=K, dist=dist, W=W, H=H,
                        extrinsics=look_at(pos, config["target"])))
    return out


def render(config: dict, seed: int, device):
    """Every (timestep, camera) view of the configuration's capture for
    ``seed``: ``(frames (T*C, H, W) uint8 on device, names ["<t>/<cam>.jpg"],
    camera index of each frame, cameras)``, timesteps outer."""
    cams = cameras(config)
    markers = cube_markers(config["cube_size"])
    tiles = marker_tiles(list(markers), config["marker_px"])
    traj = cube_trajectory(config["timesteps"], seed, tuple(config["target"]), config["wander"])
    frames, names, cam_of = [], [], []
    for t, obj in enumerate(traj):
        world = {m: (obj @ mp).astype(np.float32) for m, mp in markers.items()}
        for ci, cam in enumerate(cams):
            frames.append(render_image(cam, world, tiles, config["marker_size"], device))
            names.append(f"{t}/{cam['id']}.jpg")
            cam_of.append(ci)
    return torch.stack(frames), names, cam_of, cams
