"""A whole run of each cell on the CPU at a size a test run can hold (the
port's plain versions, a 1 Mbp genome), with the look for a card skipped:
it comes out correct as the port stands, and not correct with the timed
path broken underneath or with the configuration's control in the port's
place."""

import copy
import json
import os

import pytest

import run as R

with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench-cache"))


def tiny(workload: str, cache: str, extra=()) -> R.Cell:
    """The cell cut to a 1 Mbp genome, 200 kbp chunks and 256-read batches,
    its limits as they are."""
    cell = R.resolve(BENCH, workload)
    cfg = cell.config = copy.deepcopy(cell.config)
    cfg["genome"]["contigs"] = [["I", 600_000], ["II", 400_000]]
    cfg["chunk_bp"] = 200_000
    args = list(cfg["mem_args"])
    args[args.index("-K") + 1] = "200000"
    args[args.index("--batch") + 1] = "256"
    cfg["mem_args"] = args + list(extra)
    cell.traffic = dict(cell.traffic, pool_per_s=100, warmup_units=256,
                        sample_units=256)
    cell.cache = cache
    return cell


def result(cell, capsys, seed=2**31 + 5, trace=False) -> dict:
    rc = R.run(cell, seed, 1.0, trace, want_card=False)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def plain(monkeypatch):
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")


CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, cache, capsys):
    cell = tiny(workload, cache)
    out = result(cell, capsys)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    # no card memory to read on the CPU
    shown = {n for n, _ in cell.end_to_end} - {"peak_mem_gib"}
    assert "setup_s" in shown and shown <= set(out["metrics"])


PER_LAYER = {
    "meme-se151": {"seed.host_us.se", "finalize.host_us.se",
                   "startup.upload_s"},
    "meme-pe151": {"pe.pairs_per_s", "pair.host_us.pe", "startup.upload_s"},
}


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_per_layer(workload, cache, capsys):
    out = result(tiny(workload, cache), capsys, trace=True)
    assert out["correct"]
    assert PER_LAYER[workload] <= set(out["metrics"])
    assert out["device"]["window_s"] > 0


def half_left_out(monkeypatch):
    from bwameme_tpu_torch.pipeline import Aligner

    stream, pairs = Aligner.align_stream, Aligner.align_pairs

    def align_stream(self, batches):
        for blocks in stream(self, batches):
            yield blocks[: len(blocks) // 2]

    def align_pairs(self, reads):
        blocks = pairs(self, reads)
        return blocks[: len(blocks) // 2]

    monkeypatch.setattr(Aligner, "align_stream", align_stream)
    monkeypatch.setattr(Aligner, "align_pairs", align_pairs)


def _alter_records(monkeypatch, fields) -> None:
    """Each record changed by ``fields`` (its tab-split fields, in place)
    where the SAM is made."""
    from bwameme_tpu_torch.pipeline import Aligner

    fin_se, fin_pe = Aligner._finalize_se, Aligner._pe_finalize

    def alter(blocks):
        out = []
        for b in blocks:
            lines = []
            for line in b.rstrip("\n").split("\n"):
                f = line.split("\t")
                fields(f)
                lines.append("\t".join(f))
            out.append("\n".join(lines) + "\n")
        return out

    monkeypatch.setattr(Aligner, "_finalize_se",
                        lambda self, *a: alter(fin_se(self, *a)))
    monkeypatch.setattr(Aligner, "_pe_finalize",
                        lambda self, *a: alter(fin_pe(self, *a)))


def answer_altered(monkeypatch):
    """Each record's first base of SEQ changed where the SAM is made."""

    def seq(f):
        f[9] = ("C" if f[9][0] != "C" else "G") + f[9][1:]

    _alter_records(monkeypatch, seq)


def mapq_sixty(monkeypatch):
    """Every mapped record's MAPQ written as 60, the answer of a finalize
    that leaves out the second-best hits."""

    def mapq(f):
        if f[5] != "*":
            f[4] = "60"

    _alter_records(monkeypatch, mapq)


def mapq_nought(monkeypatch):
    """Every record's MAPQ written as 0."""

    def mapq(f):
        f[4] = "0"

    _alter_records(monkeypatch, mapq)


def xa_dropped(monkeypatch):
    """The XA tag left out of every record."""

    def xa(f):
        f[11:] = [t for t in f[11:] if not t.startswith("XA:")]

    _alter_records(monkeypatch, xa)


def state_unchanged(monkeypatch):
    """The extension step hands back the regions it was given: none."""
    from bwameme_tpu_torch.pipeline import Aligner

    def finish(self, token):
        kind, tok = token
        return [[] for _ in (tok[1] if kind == "flat" else tok[0])]

    monkeypatch.setattr(Aligner, "_kernel2_finish", finish)


FAULTS = [half_left_out, answer_altered, state_unchanged, mapq_sixty,
          mapq_nought, xa_dropped]
# paired-end, bwa-mem writes no XA for a mate whose pair took its second hit,
# so an XA left out is not a fault that a pair's records can show
CASES = [(w, f) for w in CELLS for f in FAULTS
         if not (f is xa_dropped and "pe" in w)]


@pytest.mark.parametrize(("workload", "fault"), CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_fault_is_not_correct(workload, fault, cache, capsys, monkeypatch):
    fault(monkeypatch)
    out = result(tiny(workload, cache), capsys)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, cache, capsys):
    cell = tiny(workload, cache)
    cell = tiny(workload, cache, cell.limits["control_args"])
    out = result(cell, capsys)
    assert not out["correct"], out["checks"]
