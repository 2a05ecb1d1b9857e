"""solve.device_s: seconds a solve on the dense route's device stage (the
edges' upload, the folding, the primal-dual iteration with its dense
``eigh``, the CG translations): the solver's "Optimizing + solving (device)"
phase, as its verbose log prints it, averaged over the traced run's solves."""
from perfbench import trace


def read(run):
    return trace.solver_phase_mean(run, "Optimizing + solving (device)")
