"""BENCHMARK.json: every cell's files resolve by name, and every name and
unit keeps to the allowed characters; the check on loaded modules."""

import json
import os

import pytest

import run as R
from pbench import names

with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves(workload):
    cell = R.resolve(BENCH, workload)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    assert cell.traffic["generator"] == "wgsim"
    assert cell.end_to_end and cell.per_layer
    assert any(n == "setup_s" for n, _ in cell.end_to_end)
    assert len(cell.end_to_end) >= 2
    for n, _ in cell.end_to_end + cell.per_layer:
        assert os.path.exists(os.path.join(R.HERE, "metrics", f"{n}.py"))
    assert {"missing", "field_faults", "finalize_faults",
            "score_gap_pct"} <= set(cell.limits)


def test_names_and_units():
    for c in BENCH["configs"]:
        assert names.valid_name(c["name"])
        assert all(names.valid_name(k) for k in c["reduced"])
        with open(os.path.join(R.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert set(c["reduced"]) <= set(cfg)
    for w in BENCH["workloads"]:
        assert all(names.valid_name(w[k]) for k in ("name", "config",
                                                    "traffic"))
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert names.valid_name(m["name"]) and names.valid_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
    shown = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in shown for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_forbidden_modules():
    assert names.forbidden_loaded({"jax": 1}) == ["jax"]
    assert names.forbidden_loaded({"bwameme_tpu.cli": 1}) == ["bwameme_tpu"]
    assert names.forbidden_loaded({"jaxlib.xla": 1, "flax": 1}) == [
        "flax", "jaxlib"]
    assert names.forbidden_loaded({"bwameme_tpu_torch.cli": 1,
                                   "bwameme_tpu_torch": 1,
                                   "jaxtyping": 1}) == []
