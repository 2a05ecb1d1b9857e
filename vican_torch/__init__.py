"""vican_torch: camera-network calibration (VICAN) on PyTorch and CUDA.

The port of ``vican_tpu`` to an NVIDIA H100: the same public API
(:func:`vican_torch.bipgo.bipartite_se3sync` and friends take the same edge
dict and return the same ``{node: SE3}``), plain PyTorch around one
hand-written CUDA kernel per Pallas kernel of the JAX package.  It imports
neither JAX nor ``vican_tpu``.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.

  - :mod:`vican_torch.geometry`      -- SE3 type, SO(3) utilities, gauge alignment
  - :mod:`vican_torch.cam`           -- Camera, batched marker detection + PnP
  - :mod:`vican_torch.dataset`       -- Dataset / DojoDataset loaders
  - :mod:`vican_torch.bipgo`         -- bipartite_se3sync / object_bipartite_se3sync
  - :mod:`vican_torch.plot`          -- visualization helpers
  - :mod:`vican_torch.evaluation`    -- gauge-aligned error reports (cell 9)
  - :mod:`vican_torch.serialization` -- .pt interchange + native edge format
  - :mod:`vican_torch.render`        -- synthetic scene renderer
  - :mod:`vican_torch.synthetic`     -- synthetic problems and captures
  - :mod:`vican_torch.ops`           -- the batched device operations
  - :mod:`vican_torch.parallel`      -- torch.distributed meshes, sharded solves
"""

__version__ = "0.1.0"

from . import geometry  # noqa: F401

# Submodules with heavier dependencies (torch, the C modules, cv2) import
# lazily.
__all__ = [
    "geometry",
    "cam",
    "dataset",
    "bipgo",
    "plot",
    "evaluation",
    "serialization",
    "render",
    "synthetic",
    "ops",
    "parallel",
]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
