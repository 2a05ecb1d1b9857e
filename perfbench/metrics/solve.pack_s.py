"""solve.pack_s: seconds a solve in the host packing, solver/packing.pack_problem:
the solver's "Applying constraints" phase, as its verbose log prints it, averaged over
the traced run's solves."""
from perfbench import trace


def read(run):
    return trace.solver_phase_mean(run, "Applying constraints")
