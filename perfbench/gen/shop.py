"""A shop's camera network and the object's walk through it, made from the
seed: the edges of a calibration problem as a capture of the upstream's
large_shop would give them.

``n_cams`` cameras hang at ``camera_height`` over a ``floor`` (m) on a
jittered grid, each turned to a random heading and tilted down by a pitch in
``pitch_deg``.  The 24-marker cube (``cube_size``, the room's layout) is
carried through the shop at ``object_height``: a walk that passes through
every camera's point of view (where its axis meets the carrying height) in
nearest-neighbour order from a random camera, at a constant speed over
``n_times`` timesteps, while the cube turns by a random step of about
``turn_deg`` a timestep.  A marker is seen where its centre projects inside
the ``resolution`` image of focal length ``focal_rate * (W + H)``, lies
within ``max_distance`` and faces the camera (the cosine of its normal to
the camera above ``min_facing_cos``).  So each camera sees the cube in
contiguous stretches of the walk, and each timestep a few cameras see it.
A timestep that no camera sees keeps one observation, of its nearest
camera's best-facing marker.  ``n_edges`` of the seen observations are
kept, among them one of every timestep and of every camera, the rest drawn
at random; a seed that sees fewer raises.

Measured poses carry rotation noise of concentration ``kappa_r`` and
Gaussian translation noise ``sigma_t``, as the port's synthetic problems
do.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.gen.scene import cube_markers


def _rodrigues(v: np.ndarray) -> np.ndarray:
    """Axis-angle vectors ``(n, 3)`` -> rotations ``(n, 3, 3)``."""
    theta = np.maximum(np.linalg.norm(v, axis=-1), 1e-12)
    k = v / theta[:, None]
    K = np.zeros((len(v), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + np.sin(theta)[:, None, None] * K + (1.0 - np.cos(theta))[:, None, None] * (K @ K)


def _cameras(config: dict, rng) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Camera->world rotations ``(C, 3, 3)`` (+z forward, +y down), centres
    ``(C, 3)`` and points of view ``(C, 3)``."""
    C = config["n_cams"]
    W, L = config["floor"]
    cols = int(np.ceil(np.sqrt(C * W / L)))
    rows = int(np.ceil(C / cols))
    cell = np.array([W / cols, L / rows])
    idx = rng.permutation(rows * cols)[:C]
    grid = np.stack([idx % cols, idx // cols], axis=1) + rng.uniform(0.1, 0.9, size=(C, 2))
    xy = grid * cell
    h = config["camera_height"]
    z0 = float(np.mean(config["object_height"]))
    pitch = np.radians(rng.uniform(*config["pitch_deg"], size=C))
    reach = (h - z0) / np.tan(pitch)
    heading = rng.uniform(0.0, 2.0 * np.pi, size=C)
    view = xy + reach[:, None] * np.stack([np.cos(heading), np.sin(heading)], axis=1)
    # a point of view off the floor turns the camera round
    off = (view < 0).any(axis=1) | (view > np.array([W, L])).any(axis=1)
    heading[off] += np.pi
    view = xy + reach[:, None] * np.stack([np.cos(heading), np.sin(heading)], axis=1)
    view = np.clip(view, 0.0, [W, L])
    centre = np.concatenate([xy, np.full((C, 1), h)], axis=1)
    target = np.concatenate([view, np.full((C, 1), z0)], axis=1)
    fwd = target - centre
    fwd /= np.linalg.norm(fwd, axis=1, keepdims=True)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=2), centre, target


def _walk(config: dict, targets: np.ndarray, rng) -> tuple[np.ndarray, np.ndarray]:
    """Object->world rotations ``(T, 3, 3)`` and positions ``(T, 3)``."""
    T = config["n_times"]
    C = len(targets)
    order = [int(rng.integers(C))]
    left = np.ones(C, bool)
    left[order[0]] = False
    xy = targets[:, :2]
    for _ in range(C - 1):
        d = np.linalg.norm(xy - xy[order[-1]], axis=1)
        d[~left] = np.inf
        order.append(int(np.argmin(d)))
        left[order[-1]] = False
    way = xy[order]
    legs = np.linalg.norm(np.diff(way, axis=0), axis=1)
    # timesteps a leg, at least one, in proportion to its length; every
    # point of view is a timestep's position
    share = np.maximum(1, np.floor(legs / legs.sum() * (T - 1)).astype(int))
    while share.sum() > T - 1:
        share[np.argmax(share)] -= 1
    share[np.argsort(-legs)[: T - 1 - share.sum()]] += 1
    pos = [way[i] + np.outer(np.arange(k) / k, way[i + 1] - way[i])
           for i, k in enumerate(share)]
    pos = np.concatenate(pos + [way[-1:]])
    lo, hi = config["object_height"]
    z = lo + (hi - lo) * (0.5 + 0.5 * np.sin(np.arange(T) * 2 * np.pi / 97.0
                                              + rng.uniform(0, 2 * np.pi)))
    step = rng.normal(size=(T, 3))
    step *= np.radians(config["turn_deg"]) / np.sqrt(3.0)
    R = np.empty((T, 3, 3))
    R[0] = _rodrigues(rng.normal(size=(1, 3)))[0]
    turns = _rodrigues(step)
    for t in range(1, T):
        R[t] = turns[t] @ R[t - 1]
    return R, np.concatenate([pos, z[:, None]], axis=1)


def _seen(config, Rc, tc, Ro, to, Rm, tm, device, chunk: int = 16) -> np.ndarray:
    """Keys ``(camera * T + timestep) * M + marker`` of every observation
    that the visibility rule admits, in increasing order."""
    W, H = config["resolution"]
    f = config["focal_rate"] * (W + H)
    T, M = len(Ro), len(Rm)
    dt = torch.float64
    g = lambda x: torch.as_tensor(x, device=device, dtype=dt)  # noqa: E731
    Ro_, to_, Rm_, tm_ = g(Ro), g(to), g(Rm), g(tm)
    centres = torch.einsum("tij,mj->tmi", Ro_, tm_) + to_[:, None]       # (T, M, 3)
    normals = torch.einsum("tij,mj->tmi", Ro_, Rm_[:, :, 2])             # (T, M, 3)
    keys = []
    for c0 in range(0, len(Rc), chunk):
        Rc_, tc_ = g(Rc[c0:c0 + chunk]), g(tc[c0:c0 + chunk])
        rel = centres[None] - tc_[:, None, None]                          # (c, T, M, 3)
        dist = torch.linalg.vector_norm(rel, dim=-1)
        cam = torch.einsum("cji,ctmj->ctmi", Rc_, rel)
        x = f * cam[..., 0] / cam[..., 2] + W / 2
        y = f * cam[..., 1] / cam[..., 2] + H / 2
        facing = -(normals[None] * rel).sum(-1) / dist
        ok = ((cam[..., 2] > 0.3) & (x > 0) & (x < W) & (y > 0) & (y < H)
              & (dist < config["max_distance"]) & (facing > config["min_facing_cos"]))
        c, t, m = torch.nonzero(ok, as_tuple=True)
        keys.append((((c + c0) * T + t) * M + m).cpu().numpy())
    return np.concatenate(keys)


def make(config: dict, seed: int, device="cpu") -> dict:
    """The problem's arrays: ground truth (``Rc``, ``tc`` camera->world;
    ``Rm``, ``tm`` marker->object; ``Ro``, ``to`` object->world), the edges'
    camera, timestep and marker indices (``ci``, ``ti``, ``mi``), measured
    poses (``R``, ``t``: the marker in the camera's frame), corners and
    reprojection errors (``errs``); ``seen``, the observations the rule
    admitted, and ``unseen``, the timesteps no camera saw."""
    rng = np.random.default_rng(seed)
    C, T, E = config["n_cams"], config["n_times"], config["n_edges"]
    markers = cube_markers(config["cube_size"])
    M = len(markers)
    Rm = np.stack([markers[str(m)][:3, :3] for m in range(M)])
    tm = np.stack([markers[str(m)][:3, 3] for m in range(M)])
    Rc, tc, targets = _cameras(config, rng)
    Ro, to = _walk(config, targets, rng)
    seen = _seen(config, Rc, tc, Ro, to, Rm, tm, device)
    # a timestep no camera sees: its nearest camera's best-facing marker
    ti_seen = (seen // M) % T
    unseen = np.setdiff1d(np.arange(T), ti_seen)
    if len(unseen):
        d = np.linalg.norm(to[unseen, None] - tc[None], axis=2)
        c = np.argmin(d, axis=1)
        toward = (tc[c] - to[unseen]) / d[np.arange(len(c)), c][:, None]
        normals = np.einsum("tij,mj->tmi", Ro[unseen], Rm[:, :, 2])
        m = np.argmax(np.einsum("tmi,ti->tm", normals, toward), axis=1)
        seen = np.union1d(seen, (c * T + unseen) * M + m)
    if len(seen) < E:
        raise ValueError(f"perfbench: the shop saw {len(seen)} observations, fewer than "
                         f"n_edges {E}")
    ci_all = seen // (T * M)
    ti_all = (seen // M) % T
    must = np.zeros(len(seen), bool)
    for idx in (ti_all, ci_all):
        pick = rng.permutation(len(seen))
        _, first = np.unique(idx[pick], return_index=True)
        must[pick[first]] = True
    if len(np.unique(ci_all)) < C:
        raise ValueError("perfbench: a camera of the shop saw nothing")
    rest = np.flatnonzero(~must)
    extra = rng.choice(rest, size=E - int(must.sum()), replace=False)
    key = seen[np.concatenate([np.flatnonzero(must), extra])]
    rng.shuffle(key)
    ci = (key // (T * M)).astype(np.int64)
    ti = ((key // M) % T).astype(np.int64)
    mi = (key % M).astype(np.int64)
    # Rc is camera->world: an edge's pose is the marker in the camera's frame
    R_gt = np.einsum("eji,ejk,ekl->eil", Rc[ci], Ro[ti], Rm[mi])
    t_gt = np.einsum("eji,ej->ei", Rc[ci], np.einsum("eij,ej->ei", Ro[ti], tm[mi])
                     + to[ti] - tc[ci])
    noise = rng.normal(0.0, 1.0 / np.sqrt(config["kappa_r"]), size=(E, 3))
    R = _rodrigues(noise) @ R_gt
    t = t_gt + rng.normal(0.0, config["sigma_t"], size=(E, 3))
    W, H = config["resolution"]
    corners = rng.uniform(0, W, size=(E, 4, 2)).astype(np.float32)
    errs = rng.uniform(0.0, 0.04, size=E)
    return dict(Rc=Rc, tc=tc, Rm=Rm, tm=tm, Ro=Ro, to=to, ci=ci, ti=ti, mi=mi, R=R, t=t,
                corners=corners, errs=errs, unseen=len(unseen), seen=len(seen))
