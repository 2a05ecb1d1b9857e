"""The per-layer metrics that read the program's spans and counters
(``perfbench/spans.py`` and the readers named in ``SPANS``), on the CPU at
small sizes: ``python -m pytest perfbench/tests -q``.

- a traced run of ``room8_720p.frames`` reads the host-side ones, and leaves
  out the device times, which the CPU does not record;
- a program that lacks a span or a counter (one from before they were
  added) leaves each metric out, and no reader raises.
"""
from __future__ import annotations

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

SPANS = ("feed.decode_ms", "feed.preprocess_ms", "feed.labeler_ms", "feed.gates_ms",
         "feed.candidates_upload_ms", "drain.wait_feed_ms", "drain.detect_device_ms",
         "drain.pnp_device_ms", "solve.dense_fold_s", "solve.dense_rotations_s",
         "solve.dense_translations_s")
ON_THE_CPU = {"feed.labeler_ms", "feed.gates_ms", "feed.candidates_upload_ms",
              "drain.wait_feed_ms"}
SMALL = {"config": {"cameras": 3, "timesteps": 1, "resolution": [640, 360], "batch_size": 2},
         "traffic": {"sample_frames": 3}}


@pytest.fixture
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_a_traced_frames_run_reads_the_host_spans(capsys, two_threads):
    rc = harness.main(["--workload", "room8_720p.frames", "--seed", str(2**31 + 7),
                       "--seconds", "0.5", "--trace", "1"], device="cpu", overrides=SMALL)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    read = set(result["metrics"]) & set(SPANS)
    assert read == ON_THE_CPU
    assert all(result["metrics"][m]["value"] >= 0 for m in read)
    assert {"feed.host_candidates_ms", "drain.detect_ms"} <= set(result["metrics"])


# an event of each kind as a program without the new fields records it
OLD_RUN = {"phases": [{"name": "host candidates", "stage": "feed", "start": 0.0,
                       "seconds": 0.02},
                      {"name": "detect program", "stage": "drain", "start": 0.03,
                       "seconds": 0.004},
                      {"name": "PnP", "stage": "drain", "start": 0.04, "seconds": 0.001}],
           "solver_phases": [{"Optimizing + solving (device)": 0.39}]}


@pytest.mark.parametrize("name", SPANS)
def test_a_program_without_the_span_leaves_the_metric_out(name):
    spec = harness.load_spec()
    assert name in {m["name"] for m in spec["per_layer"]}
    assert harness.load_module("metrics", name).read(OLD_RUN) is None
    assert harness.load_module("metrics", name).read({}) is None
