"""On the card: a short run of each cell comes out correct, and its control
does not. Skips without a CUDA card (``python -m pytest portbench/tests -m
card`` on the card)."""

import json
import os
import subprocess
import sys

import pytest

import run as R

with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_short_run_on_card(workload):
    need_card()
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 11), "--seconds", "5", "--trace", "0"],
        cwd=R.ROOT, capture_output=True, text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_on_card(workload, tmp_path):
    need_card()
    import calibrate

    cell = R.resolve(BENCH, workload)
    rows = calibrate.readings(cell, [2**31 + 13], 5.0,
                              tuple(cell.limits["control_args"]))
    assert any(rows[0][k] > lim for k, lim in cell.limits.items()
               if k in rows[0])
