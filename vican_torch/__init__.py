"""vican_torch: camera-network calibration (VICAN) on PyTorch and CUDA.

The port of ``vican_tpu`` to an NVIDIA H100: the same public API
(:func:`vican_torch.bipgo.bipartite_se3sync` and friends take the same edge
dict and return the same ``{node: SE3}``), plain PyTorch around one
hand-written CUDA kernel per Pallas kernel of the JAX package.  It imports
neither JAX nor ``vican_tpu``.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
