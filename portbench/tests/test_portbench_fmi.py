"""The FM-index configuration (celegans-fmi) and its cells (fmi-pe151,
fmi-se151): the configuration resolves onto the learned configuration's
genome; a traced CPU run of each cell at a tiny genome is correct and reports
the new per-layer metrics; the new readers on hand-made runs."""

import json
import os

import pytest

import run as R
from pbench import genome as genome_mod
from test_portbench_faults import result, tiny
from test_portbench_tracing_readers import view

with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

CELLS = {"fmi-se151": ("se", "meme-se151"), "fmi-pe151": ("pe", "meme-pe151")}
NEW = {"startup.fmi_load_s": ("s", "start-up", "setup_s",
                              ["fmi-pe151", "fmi-se151"]),
       "seed.unpacked_us.se": ("us/read", "seeding, host", "reads_per_s",
                               ["meme-se151", "fmi-se151"]),
       "seed.unpacked_us.pe": ("us/pair", "seeding, host", "peak_mem_gib",
                               ["meme-pe151", "fmi-pe151"])}


@pytest.mark.parametrize("workload", list(CELLS))
def test_cell_resolves_onto_the_learned_genome(workload):
    kind, learned = CELLS[workload]
    fmi, meme = R.resolve(BENCH, workload), R.resolve(BENCH, learned)
    assert fmi.config["name"] == "celegans-fmi"
    assert fmi.config["backend"] == "fmi" and fmi.chips == 1
    assert "--mode" not in fmi.config["mem_args"]
    assert fmi.config["mem_args"][:2] == ["--backend", "fmi"]
    # the same genome key: the same cache directory and .meme index
    assert genome_mod.key(fmi.config["genome"]) == genome_mod.key(
        meme.config["genome"])
    assert R.genome_dir(fmi) == R.genome_dir(meme)
    for k in ("genome", "chunk_bp", "scoring", "guarantees"):
        assert fmi.config[k] == meme.config[k], k
    assert fmi.traffic == meme.traffic
    assert fmi.limits == meme.limits
    # every metric the learned cell of its kind reports, and the new ones
    assert {n for n, _ in meme.per_layer} <= {n for n, _ in fmi.per_layer}
    assert {"startup.fmi_load_s", f"seed.unpacked_us.{kind}"} <= {
        n for n, _ in fmi.per_layer}
    shown = {n for n, _ in fmi.end_to_end}
    assert shown == {n for n, _ in meme.end_to_end}


def test_new_metric_entries():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name, (unit, layer, moves, cells) in NEW.items():
        m = entries[name]
        assert (m["unit"], m["layer"], m["moves"], m["workloads"]) == (
            unit, layer, moves, cells)
        assert os.path.exists(os.path.join(R.HERE, "metrics", f"{name}.py"))


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_unpacked_reader(kind, monkeypatch):
    from bwameme_tpu_torch import pipeline

    read = R._reader(f"seed.unpacked_us.{kind}")
    seeded = {"seed.submit": 1.0, "seed.finish": 2.0}
    # seeding ran, the fallback never did
    assert read(view(kind, tprof=seeded)) == 0.0
    # it ran: 0.5 s over 10,000 units
    assert read(view(kind, tprof={**seeded, "seed.unpacked": 0.5})) == (
        pytest.approx(50.0))
    # no seeding stages in the window, or the other kind of cell
    assert read(view(kind, tprof={"finalize": 9.0})) is None
    assert read(view("pe" if kind == "se" else "se", tprof=seeded)) is None
    # a program that names no such stage
    monkeypatch.delattr(pipeline, "UNPACKED")
    assert read(view(kind, tprof=seeded)) is None


def test_fmi_load_reader():
    read = R._reader("startup.fmi_load_s")
    assert read(view("se", spans={"index_load": 1.5, "fmi_load": 5.25})) == (
        5.25)
    assert read(view("pe", spans={"index_load": 1.5})) is None


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench-cache"))


@pytest.fixture(autouse=True)
def plain(monkeypatch):
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")


@pytest.mark.parametrize("workload", list(CELLS))
def test_traced_cpu_run_reports_the_new_metrics(workload, cache, capsys):
    kind = CELLS[workload][0]
    out = result(tiny(workload, cache), capsys, trace=True)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["startup.fmi_load_s"] > 0
    assert m["startup.load_s"] >= m["startup.fmi_load_s"]
    # the CPU's wave engine returns lists, never an outgrown pack
    assert m[f"seed.unpacked_us.{kind}"] == 0.0
    assert m[f"host.fetch_us.{kind}"] >= 0
    if kind == "pe":
        assert m["pe.pairs_per_s"] > 0
