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
