"""Host boundary: edge dict -> fused arrays (:class:`PackedProblem`).

The reference keeps the pose graph as a Python dict
``{(camera_id, "<t>_<marker>"): {"pose": SE3, ...}}`` and loops over it
(vican/bipgo.py:203-223, 243-264, 445-469).  The port crosses the
dict/string world once, here: it evaluates the user's ``edge_filter`` and
noise-model callables per edge, parses node names, and emits

  ``edata (E, 9)``  ``[qw qx qy qz | tx ty tz | k_r k_t]`` (solver dtype)
  ``eidx  (E, 3)``  ``[cam, time, marker]`` int32

the layout of ``vican_tpu.solver.packing``, whose pure-Python packer this
module copies.  Poses are read through ``.R()``/``.t()``, so edge dicts
built with either package's ``SE3`` pack identically.  Rotations travel as
quaternions when every edge rotation is orthonormal and proper, otherwise
as raw matrices (``R_e_raw``), which the reference folds as they are.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable

import numpy as np

__all__ = ["PackedProblem", "pack_problem", "pack_constraints", "packed_from_arrays"]


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrices -> unit quaternions (w, x, y, z), Shepperd's branch
    selection done with np.where over the whole batch."""
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    tr = m00 + m11 + m22

    s0 = np.sqrt(np.maximum(tr + 1.0, 1e-12)) * 2.0
    c0 = np.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], 1)
    s1 = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2.0
    c1 = np.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], 1)
    s2 = np.sqrt(np.maximum(1.0 + m11 - m00 - m22, 1e-12)) * 2.0
    c2 = np.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], 1)
    s3 = np.sqrt(np.maximum(1.0 + m22 - m00 - m11, 1e-12)) * 2.0
    c3 = np.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], 1)

    use0 = (tr > 0)[:, None]
    use1 = ((m00 >= m11) & (m00 >= m22))[:, None] & ~use0
    use2 = (m11 >= m22)[:, None] & ~use0 & ~use1
    q = np.where(use0, c0, np.where(use1, c1, np.where(use2, c2, c3)))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Host inverse of :func:`_mat_to_quat` (matches ops.lie.quat_to_mat)."""
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((len(q), 3, 3), q.dtype)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - z * w)
    R[:, 0, 2] = 2 * (x * z + y * w)
    R[:, 1, 0] = 2 * (x * y + z * w)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - x * w)
    R[:, 2, 0] = 2 * (x * z - y * w)
    R[:, 2, 1] = 2 * (y * z + x * w)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _sorted_remap(id_list: list, prov_idx: np.ndarray) -> tuple[list, np.ndarray]:
    """Remap first-appearance ids/indices to lexicographic order: the
    reference's ``np.unique`` over node names (bipgo.py:225-229), which
    fixes the gauge anchor at node 0 (bipgo.py:295)."""
    order = sorted(range(len(id_list)), key=id_list.__getitem__)
    inv = np.empty(len(order), np.int32)
    inv[np.asarray(order, np.int32)] = np.arange(len(order), dtype=np.int32)
    return [id_list[i] for i in order], inv[prov_idx]


@dataclass
class PackedProblem:
    """A bipartite camera<->time pose graph in fused array form.

    Per filtered edge ``e`` (camera ``eidx[e,0]`` observed marker
    ``eidx[e,2]`` at time ``eidx[e,1]``), ``edata[e]`` holds the measured
    camera->marker rotation as a unit quaternion (wxyz), the translation and
    the rotation/translation weights.  Duplicate (camera, time) cells are
    summed by the solver's scatter-add (the reference's per-(c,t)
    aggregation, bipgo.py:215-221).  ``has_quats`` False: the quaternion
    slots are unused and the raw matrices are in ``R_e_raw``.
    """

    cam_ids: list
    time_ids: list
    marker_ids: list
    edata: np.ndarray  # (E, 9): [q(4) | t(3) | k_r | k_t]
    eidx: np.ndarray  # (E, 3) int32: [cam, time, marker]
    R_con: np.ndarray
    t_con: np.ndarray
    root_idx: int
    # factor the rotation weights were divided by in float32 normalization;
    # the certificate threshold is divided by it too
    k_r_scale: float = 1.0
    has_quats: bool = True
    R_e_raw: np.ndarray | None = None

    @property
    def q_e(self) -> np.ndarray | None:
        return self.edata[:, :4] if self.has_quats else None

    @property
    def t_e(self) -> np.ndarray:
        return self.edata[:, 4:7]

    @property
    def k_r(self) -> np.ndarray:
        return self.edata[:, 7]

    @property
    def k_t(self) -> np.ndarray:
        return self.edata[:, 8]

    @property
    def cam_idx(self) -> np.ndarray:
        return self.eidx[:, 0]

    @property
    def time_idx(self) -> np.ndarray:
        return self.eidx[:, 1]

    @property
    def marker_idx(self) -> np.ndarray:
        return self.eidx[:, 2]

    @property
    def R_e(self) -> np.ndarray:
        """Edge rotation matrices (from the quaternions, or the raw array)."""
        if self.R_e_raw is None:
            self.R_e_raw = _quat_to_mat(self.edata[:, :4])
        return self.R_e_raw

    @property
    def num_cams(self) -> int:
        return len(self.cam_ids)

    @property
    def num_times(self) -> int:
        return len(self.time_ids)

    @property
    def num_edges(self) -> int:
        return int(self.edata.shape[0])


_FIELDS = (
    "cam_ids", "time_ids", "marker_ids", "edata", "eidx", "R_con", "t_con",
    "root_idx", "k_r_scale", "has_quats", "R_e_raw",
)


def packed_from_arrays(fields: dict) -> PackedProblem:
    """A :class:`PackedProblem` from a dict of numpy arrays and id lists.

    Keys: ``edata``, ``eidx``, ``R_con``, ``t_con``, ``root_idx``,
    ``cam_ids``, ``time_ids``, ``marker_ids``, ``k_r_scale``, ``has_quats``,
    ``R_e_raw`` (may be None).  This is the packed state the solvers start
    from; filled from another packer's output, it lets the solvers be
    compared apart from packing.
    """
    missing = [k for k in _FIELDS if k not in fields]
    if missing:
        raise KeyError(f"packed_from_arrays: missing fields {missing}")
    raw = fields["R_e_raw"]
    return PackedProblem(
        cam_ids=list(fields["cam_ids"]),
        time_ids=list(fields["time_ids"]),
        marker_ids=list(fields["marker_ids"]),
        edata=np.array(fields["edata"]),
        eidx=np.array(fields["eidx"], np.int32),
        R_con=np.array(fields["R_con"]),
        t_con=np.array(fields["t_con"]),
        root_idx=int(fields["root_idx"]),
        k_r_scale=float(fields["k_r_scale"]),
        has_quats=bool(fields["has_quats"]),
        R_e_raw=None if raw is None else np.array(raw),
    )


def pack_constraints(
    constraints: dict, dtype=np.float64
) -> tuple[list[str], np.ndarray, np.ndarray, int]:
    """Constraint dict -> (marker order, R stack, t stack, root index).

    The root is ``str(min(keys))``, a lexicographic min over string keys,
    as in the reference (bipgo.py:196,411).
    """
    marker_ids = list(constraints.keys())
    root_key = str(min(marker_ids))
    order = {m: i for i, m in enumerate(marker_ids)}
    R_con = np.stack([np.asarray(constraints[m].R(), dtype=dtype) for m in marker_ids])
    t_con = np.stack(
        [np.asarray(constraints[m].t(), dtype=dtype).reshape(3) for m in marker_ids]
    )
    return marker_ids, R_con, t_con, order[root_key]


def _intern(names: list) -> tuple[list, np.ndarray]:
    """First-appearance interning: (unique names, provisional index array)."""
    seen: dict = {}
    idx = np.empty(len(names), np.int32)
    uniq = []
    for i, s in enumerate(names):
        j = seen.get(s)
        if j is None:
            j = len(uniq)
            seen[s] = j
            uniq.append(s)
        idx[i] = j
    return uniq, idx


def _pack_edges(src_edges, marker2idx, noise_model_r, noise_model_t, edge_filter, dtype):
    """One pass over the dict: filter, parse keys, fill the fused buffers."""
    kept = []
    skipped = 0
    for k, v in src_edges.items():
        if not edge_filter(v):
            continue
        tm = k[1].partition("_")  # first underscore
        if tm[1] != "_":
            raise ValueError(f"edge key {k!r} has no '_'")
        if tm[2] not in marker2idx:
            skipped += 1
            continue
        kept.append((k[0], tm[0], tm[2], v))
    if skipped:
        warnings.warn(
            f"dropping {skipped} edge(s) whose marker has no constraint pose "
            "(the reference raises KeyError here — bipgo.py:209)",
            stacklevel=3,
        )
    if not kept:
        raise ValueError("edge_filter removed every edge; nothing to synchronize")
    poses = [v["pose"] for _, _, _, v in kept]
    E = len(kept)
    R_e = np.array([p.R() for p in poses], dtype=dtype)
    edata = np.zeros((E, 9), dtype)
    edata[:, 4:7] = np.array([p.t() for p in poses], dtype=dtype).reshape(-1, 3)
    edata[:, 7] = [noise_model_r(v) for _, _, _, v in kept]
    edata[:, 8] = [noise_model_t(v) for _, _, _, v in kept]

    ortho = np.abs(np.einsum("eij,ekj->eik", R_e, R_e) - np.eye(3)).max()
    proper = np.linalg.det(R_e).min() > 0.5  # reflections are not rotations
    has_quats = bool(ortho < 1e-3 and proper)
    if has_quats:
        edata[:, :4] = _mat_to_quat(R_e).astype(dtype)

    cam_ids, cam_idx = _sorted_remap(*_intern([c for c, _, _, _ in kept]))
    time_ids, time_idx = _sorted_remap(*_intern([t for _, t, _, _ in kept]))
    eidx = np.stack(
        [cam_idx, time_idx,
         np.array([marker2idx[m] for _, _, m, _ in kept], np.int32)], 1
    ).astype(np.int32)
    return edata, eidx, cam_ids, time_ids, has_quats, (None if has_quats else R_e)


def pack_problem(
    src_edges: dict,
    constraints: dict,
    noise_model_r: Callable,
    noise_model_t: Callable,
    edge_filter: Callable,
    dtype=np.float64,
) -> PackedProblem:
    """Filter + parse the edge dict into a :class:`PackedProblem`."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    dtype = np.dtype(dtype)
    marker_ids, R_con, t_con, root_idx = pack_constraints(constraints, dtype)
    marker2idx = {m: i for i, m in enumerate(marker_ids)}
    edata, eidx, cam_ids, time_ids, has_quats, R_e_raw = _pack_edges(
        src_edges, marker2idx, noise_model_r, noise_model_t, edge_filter, dtype
    )

    # The sync problem is well-posed only on a connected graph: each extra
    # component adds 3 kernel dimensions to the Laplacian.  Keep the
    # largest component and say so.
    n_cams_all = len(cam_ids)
    n_nodes = n_cams_all + len(time_ids)
    cam_idx = eidx[:, 0]
    time_idx = eidx[:, 1]
    adj = coo_matrix(
        (np.ones(len(cam_idx), np.int8), (cam_idx, n_cams_all + time_idx)),
        shape=(n_nodes, n_nodes),
    )
    _, roots = connected_components(adj, directed=False)
    largest = np.bincount(roots).argmax()
    keep_edge = roots[cam_idx] == largest
    if not keep_edge.all():
        n_dropped_cams = int((roots[:n_cams_all] != largest).sum())
        warnings.warn(
            f"pose graph is disconnected: dropping {int((~keep_edge).sum())} edges "
            f"and {n_dropped_cams} camera node(s) outside the largest component",
            stacklevel=2,
        )
        kept = np.nonzero(keep_edge)[0]
        edata = edata[kept]
        eidx = eidx[kept]
        if R_e_raw is not None:
            R_e_raw = R_e_raw[kept]
        # compress node indices; np.unique keeps the lexicographic order
        used_c = np.unique(eidx[:, 0])
        remap_c = np.full(n_cams_all, -1, np.int32)
        remap_c[used_c] = np.arange(len(used_c), dtype=np.int32)
        eidx[:, 0] = remap_c[eidx[:, 0]]
        cam_ids = [cam_ids[i] for i in used_c]
        used_t = np.unique(eidx[:, 1])
        remap_t = np.full(len(time_ids), -1, np.int32)
        remap_t[used_t] = np.arange(len(used_t), dtype=np.int32)
        eidx[:, 1] = remap_t[eidx[:, 1]]
        time_ids = [time_ids[i] for i in used_t]

    k_r_scale = 1.0
    if dtype == np.float32:
        # noise models can reach ~1e16 (main.ipynb cell 3), whose squares
        # overflow float32; the solve is invariant to a global weight scale,
        # so normalize each weight column to max = 1
        m = float(np.max(np.abs(edata[:, 7]))) if len(edata) else 0.0
        if m > 0:
            edata[:, 7] /= m
            k_r_scale = m
        m = float(np.max(np.abs(edata[:, 8]))) if len(edata) else 0.0
        if m > 0:
            edata[:, 8] /= m

    return PackedProblem(
        cam_ids=cam_ids,
        time_ids=time_ids,
        marker_ids=marker_ids,
        edata=edata,
        eidx=eidx,
        R_con=R_con,
        t_con=t_con,
        root_idx=root_idx,
        k_r_scale=k_r_scale,
        has_quats=has_quats,
        R_e_raw=R_e_raw,
    )
