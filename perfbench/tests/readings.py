"""Readings of a cell's compared numbers over many seeds, in one process:
the program's (set-up, ``calls`` calls, then the check, as a run makes
them) and the control's (the driver's ``control``: the reference in the
precision below the configuration's, in the program's place).  The limits
in the configuration files were set from these readings (PERF.md).

On the card:

    python3 perfbench/tests/readings.py <cell> <calls> <seed> [<seed> ...]

prints one JSON line a seed and side, then the largest reading of each
number on each side.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from perfbench import harness  # noqa: E402


def readings(workload: str, calls: int, seeds, device: str = "cuda", overrides=None):
    spec = harness.load_spec()
    _, config, traffic = harness.cell_parts(spec, workload)
    for key, part in (overrides or {}).items():
        {"config": config, "traffic": traffic}[key].update(part)
    driver = harness.load_module("drivers", traffic["driver"])
    out = []
    for seed in seeds:
        state = driver.setup(config, traffic, seed, device, False)
        for _ in range(calls):
            driver.call(state)
        driver.release(state)
        ctl = driver.control(state)
        checks, failed = driver.check(state)
        out.append({"seed": seed, "side": "program", "failed": failed,
                    "readings": state.readings})
        out.append({"seed": seed, "side": "control", "readings": ctl})
        print(json.dumps(out[-2]), flush=True)
        print(json.dumps(out[-1]), flush=True)
        del state
    return out


if __name__ == "__main__":
    rows = readings(sys.argv[1], int(sys.argv[2]), [int(s) for s in sys.argv[3:]])
    for side in ("program", "control"):
        worst = {}
        for r in rows:
            if r["side"] == side:
                for k, v in r["readings"].items():
                    worst[k] = max(worst.get(k, 0.0), v)
        print(json.dumps({"side": side, "largest": worst}), flush=True)
