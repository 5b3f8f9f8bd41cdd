"""The readers of the port's host spans (metrics/encode.host_us.*,
io.parse_us.*, extend.native_us.*, finalize.native_us.*, pair.native_us.pe,
host.fetch_us.*, host.gc_us.*, host.unspanned_pct.*) on hand-made runs, then
a traced run of each cell on the CPU that reports all of them."""

import json
import os

import pytest

import run as R
from test_portbench_faults import result, tiny

with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

# metric -> the TPROF keys it sums
SUMS = {
    "encode.host_us": ("encode",),
    "io.parse_us": ("io.parse",),
    "extend.native_us": ("extend.native",),
    "finalize.native_us": ("finalize.native",),
    "host.fetch_us": ("seed.fetch", "extend.fetch", "pair.fetch"),
    "host.gc_us": ("gc",),
}
NEW = {
    "se": [f"{m}.se" for m in SUMS] + ["host.unspanned_pct.se"],
    "pe": [f"{m}.pe" for m in SUMS] + ["pair.native_us.pe",
                                       "host.unspanned_pct.pe"],
}
TPROF = {
    "encode": 0.4, "io.parse": 1.5, "extend.native": 2.0,
    "finalize.native": 8.0, "pair.native": 3.0, "seed.fetch": 0.25,
    "extend.fetch": 0.5, "pair.fetch": 0.125, "gc": 0.75, "spanned": 27.0,
    "finalize": 9.0, "extend.finish": 4.0,
}


def view(kind, tprof=None, spans=None, units=10_000, window_s=30.0):
    return R.RunView(kind=kind, units=units, window_s=window_s, setup_s=20.0,
                     peak_bytes=0, spans={"io": 2.0} if spans is None else spans,
                     tprof=dict(TPROF) if tprof is None else tprof,
                     launches={})


def test_every_reader_has_its_entry():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for kind, cell in (("se", "meme-se151"), ("pe", "meme-pe151")):
        for name in NEW[kind]:
            m = entries[name]
            assert m["workloads"] == [cell] and m["source"] == "program_span"
            assert m["moves"] == ("reads_per_s" if kind == "se"
                                  else "peak_mem_gib")


@pytest.mark.parametrize("kind", ["se", "pe"])
@pytest.mark.parametrize("metric", list(SUMS))
def test_us_a_unit(kind, metric):
    read = R._reader(f"{metric}.{kind}")
    want = 1e6 * sum(TPROF[k] for k in SUMS[metric]) / 10_000
    assert read(view(kind)) == pytest.approx(want)
    other = "pe" if kind == "se" else "se"
    assert read(view(other)) is None
    # the parent's TPROF: none of the new keys
    assert read(view(kind, tprof={"finalize": 9.0})) is None


def test_pair_native_pe():
    read = R._reader("pair.native_us.pe")
    assert read(view("pe")) == pytest.approx(300.0)
    assert read(view("se")) is None
    assert read(view("pe", tprof={"pe.dedup": 4.0})) is None


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_unspanned_pct(kind):
    read = R._reader(f"host.unspanned_pct.{kind}")
    # 30 s less 27 s under a stage less the io span beyond the parse
    assert read(view(kind)) == pytest.approx(100 * (30 - 27 - 0.5) / 30)
    # an io span shorter than the parse it holds takes nothing off
    assert read(view(kind, spans={"io": 1.0})) == pytest.approx(10.0)
    assert read(view("pe" if kind == "se" else "se")) is None
    for key in ("spanned", "io.parse"):
        t = dict(TPROF)
        del t[key]
        assert read(view(kind, tprof=t)) is None
    assert read(view(kind, spans={})) is None
    assert read(view(kind, window_s=0.0)) is None


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench-cache"))


@pytest.fixture(autouse=True)
def plain(monkeypatch):
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")


@pytest.mark.parametrize("workload,kind", [("meme-se151", "se"),
                                           ("meme-pe151", "pe")])
def test_traced_run_reports_the_host_split(workload, kind, cache, capsys):
    out = result(tiny(workload, cache), capsys, trace=True)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW[kind]) <= set(m)
    assert m[f"finalize.native_us.{kind}"] <= m[f"finalize.host_us.{kind}"]
    assert 0 <= m[f"host.unspanned_pct.{kind}"] < 100
