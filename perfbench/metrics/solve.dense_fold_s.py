"""solve.dense_fold_s: seconds a solve in the dense route's upload of the edges
and constraint folding (``bipgo._device_arrays``, ``solver/core.fold_constraints``):
the solver's "Folding constraints (device)" phase, as its verbose log prints it,
averaged over the traced run's solves."""
from perfbench import trace


def read(run):
    return trace.solver_phase_mean(run, "Folding constraints (device)")
