"""The port's ``PhaseTimer`` (``vican_torch.utils.timing``) against the JAX
package's: ``phase`` takes the same arguments, ``sync`` by keyword or by
position and ``out["sync"]`` set in the body, and records one event a
phase."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vican_torch.utils import PhaseTimer as TorchTimer
from vican_tpu.utils import PhaseTimer as JaxTimer


def _enter(timer, how, value):
    """One phase named ``how``, its ``sync`` handed over as ``how`` says."""
    if how == "none":
        ctx = timer.phase(how)
    elif how == "keyword_none":
        ctx = timer.phase(how, sync=None)
    elif how == "keyword":
        ctx = timer.phase(how, sync=value)
    elif how == "positional":
        ctx = timer.phase(how, value)
    else:
        ctx = timer.phase(how)
    with ctx as out:
        if how == "out":
            out["sync"] = value
    return out


@pytest.mark.parametrize("how", ["none", "keyword_none", "keyword", "positional", "out"])
def test_phase_takes_sync_like_jax(how):
    x = np.arange(6.0).reshape(2, 3)
    jt, tt = JaxTimer(verbose=False), TorchTimer(verbose=False, device="cpu")
    _enter(jt, how, jnp.asarray(x))
    _enter(tt, how, torch.tensor(x))
    for timer in (jt, tt):
        assert len(timer.events) == 1
        assert timer.events[0]["name"] == how and timer.events[0]["seconds"] >= 0
    assert tt.events[0]["stage"] is None  # a second positional argument is sync
    assert list(tt.as_dict()) == list(jt.as_dict()) == [how]


def test_phase_sync_takes_nested_tensors_and_stage_stays_a_keyword():
    """``sync`` may be a nested list, tuple or dict of tensors (JAX's may be
    a pytree); ``stage`` is keyword-only."""
    tt = TorchTimer(verbose=False, device="cpu")
    tree = {"a": [torch.zeros(2), (torch.ones(3), None)], "b": torch.eye(2)}
    with tt.phase("nested", sync=tree, stage="drain"):
        pass
    assert [(e["name"], e["stage"]) for e in tt.events] == [("nested", "drain")]
    with pytest.raises(TypeError):
        with tt.phase("three positional", None, "drain"):
            pass
    assert len(tt.events) == 1


def test_events_name_their_parent_on_their_own_thread():
    """``parent`` is the phase open around an event on the same thread:
    nested phases name it, and two threads that nest at once each see only
    their own."""
    import threading

    tt = TorchTimer(verbose=False, device="cpu")
    with tt.phase("outer"):
        with tt.phase("inner"):
            with tt.phase("innermost"):
                pass
        with tt.phase("second inner"):
            pass
    with tt.phase("after"):
        pass
    parents = {e["name"]: e["parent"] for e in tt.events}
    assert parents == {"outer": None, "inner": "outer", "innermost": "inner",
                       "second inner": "outer", "after": None}

    tt = TorchTimer(verbose=False, device="cpu")
    both_open = threading.Barrier(2, timeout=30)

    def run(tag):
        with tt.phase(f"{tag} outer"):
            both_open.wait()  # each thread's outer phase is open at once
            with tt.phase(f"{tag} inner"):
                both_open.wait()

    threads = [threading.Thread(target=run, args=(tag,)) for tag in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    parents = {e["name"]: e["parent"] for e in tt.events}
    assert parents == {"a outer": None, "a inner": "a outer",
                       "b outer": None, "b inner": "b outer"}


def test_batch_counters_and_device_time_of_an_event():
    """``in_batch`` sets ``batch`` on the calling thread's events only;
    the body's counters are fields of its event; ``device_seconds`` is None
    on the CPU and without a device."""
    import threading

    tt = TorchTimer(verbose=False, device="cpu")
    with tt.in_batch(3):
        with tt.phase("counted", stage="feed") as out:
            out["candidates"] = 7
            out["labeler_s"] = 0.5
        other = threading.Thread(target=_one_phase, args=(tt, "elsewhere"))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
    with tt.phase("outside"):
        pass
    ev = {e["name"]: e for e in tt.events}
    assert ev["counted"]["batch"] == 3 and ev["elsewhere"]["batch"] is None
    assert ev["outside"]["batch"] is None
    assert ev["counted"]["candidates"] == 7 and ev["counted"]["labeler_s"] == 0.5
    assert all(e["device_seconds"] is None for e in tt.events)
    nodev = TorchTimer(verbose=False)
    with nodev.phase("no device", device_time=True):
        pass
    assert nodev.events[0]["device_seconds"] is None


def test_only_a_device_timed_phase_records_events(monkeypatch):
    """On a CUDA timer a phase synchronizes its stream at its end and
    records no timing event unless opened with ``device_time=True``; such
    a phase records two on its stream, around the synchronization's start,
    reads their time into ``device_seconds`` and hands them back to the
    thread's pool for the next."""
    calls = []

    class Stream:
        device_index = 0

        def synchronize(self):
            calls.append("synchronize")

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            calls.append("Event")

        def record(self, stream):
            calls.append("record")

        def elapsed_time(self, other):
            return 2.0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: Stream())
    monkeypatch.setattr(torch.cuda, "Event", Event)
    tt = TorchTimer(verbose=False, device="cuda")
    with tt.phase("upload", stage="feed"):
        pass
    assert calls == ["synchronize"]
    calls.clear()
    for _ in range(2):
        with tt.phase("PnP", stage="drain", device_time=True):
            pass
    assert calls == ["Event", "Event", "record", "record", "synchronize",
                     "record", "record", "synchronize"]
    assert [e["device_seconds"] for e in tt.events] == [None, 0.002, 0.002]
    with pytest.raises(ValueError, match="host-only"):
        with tt.phase("decode", host_only=True, device_time=True):
            pass


def _one_phase(timer, name):
    with timer.phase(name):
        pass


def test_a_host_only_phase_waits_for_nothing(monkeypatch):
    """A host-only phase synchronizes no stream and records no event, on a
    timer whose device is a CUDA card as on any other; it takes no
    ``sync``.  Its event has every field of another's."""
    calls = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: calls.append("current_stream"))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: calls.append("Event"))
    tt = TorchTimer(verbose=False, device="cuda")
    with tt.phase("decode", stage="feed", host_only=True) as out:
        out["frames"] = 2
    assert calls == []
    e = tt.events[0]
    assert set(e) == {"name", "stage", "start", "parent", "batch", "device_seconds",
                      "seconds", "frames"}
    assert e["device_seconds"] is None and e["seconds"] >= 0
    with pytest.raises(ValueError, match="host-only"):
        with tt.phase("decode", torch.zeros(1), host_only=True):
            pass


def test_verbose_lines_keep_their_format(capsys):
    """Every phase, nested or host-only, prints ``<name> (<s>s).``, the
    line the reference prints, as it ends."""
    tt = TorchTimer(verbose=True, device="cpu")
    with tt.phase("Optimizing + solving (device)"):
        with tt.phase("Folding constraints (device)"):
            pass
    with tt.phase("decode", host_only=True):
        pass
    lines = capsys.readouterr().out.splitlines()
    import re

    assert [re.sub(r"\(\d+\.\d{3}s\)\.$", "(Xs).", line) for line in lines] == [
        "Folding constraints (device) (Xs).", "Optimizing + solving (device) (Xs).",
        "decode (Xs)."]
