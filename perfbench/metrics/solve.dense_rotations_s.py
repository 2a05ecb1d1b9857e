"""solve.dense_rotations_s: seconds a solve in the dense route's rotation stage
(``solver/core.so3_sync``: the block operator, a dense ``eigh`` an iteration
and the duals, with a host read of the certificate an iteration): the
solver's "Rotation sync (device)" phase, as its verbose log prints it,
averaged over the traced run's solves."""
from perfbench import trace


def read(run):
    return trace.solver_phase_mean(run, "Rotation sync (device)")
