"""solve.dense_translations_s: seconds a solve in the dense route's translation
stage (``solver/core.translation_rhs``, the CG with a host read an iteration,
the residual): the solver's "Translations (device)" phase, as its verbose log
prints it, averaged over the traced run's solves."""
from perfbench import trace


def read(run):
    return trace.solver_phase_mean(run, "Translations (device)")
