"""Edge-dict serialization: the reference ``.pt`` interchange and a packed
``.npz`` format.

The port's copy of ``vican_tpu.serialization``.  The reference checkpoints
its perception stage with ``torch.save(edges, '<root>/cam_marker_edges.pt')``
(main.ipynb cells 3/5) and its published datasets ship those files
(README.md:18).  Their pickle stream holds ``vican.geometry.SE3``
instances; a file saved by the JAX package holds ``vican_tpu.geometry.SE3``
ones.  :func:`load_edges` maps both, and the port's own class, onto
:class:`vican_torch.geometry.SE3` while unpickling, so such a file loads
without either package installed.

The ``.npz`` format stores the edge dict as packed arrays: loading it
unpickles no Python objects, which is an order of magnitude faster for
large graphs.
"""
from __future__ import annotations

import io
import json
import pickle

import numpy as np
import torch

from .geometry import SE3

__all__ = ["load_edges", "save_edges", "save_edges_npz", "load_edges_npz"]


class _CompatUnpickler(pickle.Unpickler):
    """Unpickler that maps the pose classes of the reference, of the JAX
    package and of the port onto the port's :class:`SE3`."""

    _CLASS_MAP = {
        ("vican.geometry", "SE3"): SE3,
        ("vican_tpu.geometry", "SE3"): SE3,
        ("vican_torch.geometry", "SE3"): SE3,
    }

    def find_class(self, module, name):
        mapped = self._CLASS_MAP.get((module, name))
        if mapped is not None:
            return mapped
        return super().find_class(module, name)


class _CompatPickleModule:
    """Module-shaped shim handed to ``torch.load`` as ``pickle_module``."""

    Unpickler = _CompatUnpickler
    load = staticmethod(lambda f, **kw: _CompatUnpickler(f).load())

    @staticmethod
    def loads(data, **kw):
        return _CompatUnpickler(io.BytesIO(data)).load()


def load_edges(path: str) -> dict:
    """Load an edge dict from a ``.pt`` file (the reference's, the JAX
    package's or the port's) or from :func:`save_edges_npz` output
    (detected by the extension)."""
    if str(path).endswith(".npz"):
        return load_edges_npz(path)
    return torch.load(path, pickle_module=_CompatPickleModule, weights_only=False)


def save_edges(path: str, edges: dict) -> None:
    """Save an edge dict in the torch ``.pt`` pickle format."""
    torch.save(edges, path)


def save_edges_npz(path: str, edges: dict) -> None:
    """Save an edge dict as packed arrays (the fast native format)."""
    E = len(edges)
    keys_a, keys_b = [], []
    poses = np.empty((E, 4, 4), dtype=np.float32)
    corners = np.zeros((E, 4, 2), dtype=np.float32)
    errs = np.empty((E,), dtype=np.float32)
    filenames = []
    for i, (k, v) in enumerate(edges.items()):
        keys_a.append(k[0])
        keys_b.append(k[1])
        poses[i] = v["pose"].pose()
        if v.get("corners") is not None:
            corners[i] = np.asarray(v["corners"], dtype=np.float32).reshape(4, 2)
        errs[i] = v.get("reprojected_err", 0.0)
        filenames.append(v.get("im_filename", ""))
    np.savez_compressed(
        path,
        keys=json.dumps([keys_a, keys_b]).encode(),
        poses=poses,
        corners=corners,
        reprojected_err=errs,
        im_filenames=json.dumps(filenames).encode(),
    )


def load_edges_npz(path: str) -> dict:
    """Load the packed format back into the reference edge-dict schema."""
    data = np.load(path, allow_pickle=False)
    keys_a, keys_b = json.loads(bytes(data["keys"]).decode())
    filenames = json.loads(bytes(data["im_filenames"]).decode())
    poses = data["poses"]
    corners = data["corners"]
    errs = data["reprojected_err"]
    out = {}
    for i, (a, b) in enumerate(zip(keys_a, keys_b)):
        out[(a, b)] = {
            "pose": SE3(pose=poses[i]),
            "corners": corners[i],
            "reprojected_err": float(errs[i]),
            "im_filename": filenames[i],
        }
    return out
