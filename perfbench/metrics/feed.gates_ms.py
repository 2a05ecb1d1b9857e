"""feed.gates_ms: thread-milliseconds a batch in the candidates' winding, gates
and re-fit (``gate_window`` of ``_native/quad_gates.h``, or the numpy gates
without it): the counter ``gates_s`` of the "host candidates" span, summed
over the threads of its one call, averaged over every batch of the window's
captures."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "host candidates", "feed", "gates_s")
