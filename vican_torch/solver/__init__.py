"""Solver of the port: packing, the dense route, the large-graph route and
the CheFSI filter kernel."""
from .packing import PackedProblem, pack_problem, packed_from_arrays

__all__ = ["PackedProblem", "pack_problem", "packed_from_arrays"]
