"""Solver of the port: packing (the C edge packer and its pure-Python
path), the dense route, the large-graph route (materialized and streaming)
and the wrappers of their CUDA kernels."""
from .packing import PackedProblem, pack_problem, packed_from_arrays

__all__ = ["PackedProblem", "pack_problem", "packed_from_arrays"]
