"""The port's host spans on the CPU (plain versions, the device engines'
paths): inside the host stages, ``<layer>.native`` times a call into the C++
host library and ``<layer>.fetch`` a blocking readback; ``encode`` the reads'
encoding, ``io.parse`` the FASTQ parse, ``spanned`` the time under any
stage, and, while a trace runs, ``gc`` the garbage collector. With each of
the two benchmarked engines, the learned one and the FM-index one on its
card path (a stand-in for ``fmi_smem``), one single-end stream of three
batches and one paired-end chunk (three batches of the learned engine's
lanes, one of the FM-index engine, which has none): every span is there,
nests inside its stage, counts batches and not reads, and leaves the SAM as
it was."""

import contextlib
import dataclasses
import gc
import time

import numpy as np
import pytest
import torch

from bwameme_tpu_torch.index import bntseq
from bwameme_tpu_torch.index.build import build_index
from bwameme_tpu_torch.index.fmindex import build_fm_index
from bwameme_tpu_torch.io import fastq
from bwameme_tpu_torch.io.fastq import Read
from bwameme_tpu_torch.ops import fmi_search, sw_global
from bwameme_tpu_torch.pipeline import Aligner
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.seeding.fmi_engine import FmiDeviceEngine, FmiHostEngine
from bwameme_tpu_torch.utils import timer
from bwameme_tpu_torch.utils.config import MEM_F_PE, MemOptions
from bwameme_tpu_torch.utils.timer import SPANNED, TPROF

LANES = 32
KINDS = ("se", "pe")
ENGINES = ("learned", "fmi")
# the readbacks of a batch fetched whole: the pack, then the slot planes (a
# round's of the learned engine, the one launch's of the FM-index engine)
UNPACKED_FETCHES = {"learned": 4, "fmi": 2}
# the spans each kind's path gains
NEW = {
    "se": ("encode", "seed.fetch", "extend.native", "extend.fetch",
           "finalize.native"),
    "pe": ("encode", "seed.fetch", "extend.native", "extend.fetch",
           "pair.native", "pair.fetch", "finalize.native"),
}
# the stages that no other stage holds
OUTER = {
    "se": ("encode", "seed.submit", "seed.finish", "extend.submit",
           "extend.finish", "finalize"),
    "pe": ("encode", "seed.submit", "seed.finish", "extend.submit",
           "extend.finish", "pe.dedup", "pe.pestat", "pe.rescue",
           "pe.finalize"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(codes) -> str:
    return "".join("ACGTN"[c] for c in codes)


class CardFmi(FmiDeviceEngine):
    """FmiDeviceEngine on its card path (the launch, the pack, the flat
    finish, the whole-plane fetch) with a stand-in for ``fmi_smem``:
    FmiHostEngine's SMEMs, in its emission order as the kernel's, in the
    kernel's slot planes."""

    def _smem(self, codes, lens, M, steps=False):
        host = FmiHostEngine(self.idx, self.opt, fm=self.fm)
        lists = [host.collect_smems(c[:n])
                 for c, n in zip(codes.numpy(), lens.tolist())]
        slots = np.zeros((4, len(lists), M), np.int32)
        for i, sm in enumerate(lists):
            for k, sme in enumerate(sm[:M]):
                slots[:, i, k] = dataclasses.astuple(sme)
        return (torch.from_numpy(slots),
                torch.tensor([len(sm) for sm in lists], dtype=torch.int32))


@pytest.fixture(scope="module", params=ENGINES)
def setup(request):
    """A 60 kbp contig with planted repeats, a device engine on the CPU,
    96 single-end reads of 151 bp (three batches of LANES) and 40 pairs (80
    reads), four of whose second mates have no 19-mer seed, so that only
    the rescue places them."""
    rng = np.random.default_rng(1717)
    n = 60000
    code = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(4):
        src, dst = (int(x) for x in rng.integers(0, n - 600, 2))
        code[dst: dst + 500] = code[src: src + 500]
    bns = bntseq.BntSeq(l_pac=n, contigs=[bntseq.Contig("chrT", "", 0, n, 0)],
                        ambs=[], code=code)
    idx = build_index(bns, rmi_bits=11)
    opt = MemOptions()
    if request.param == "learned":
        engine = DeviceSeedingEngine(idx, opt, lanes=LANES, device="cpu")
    else:
        engine = CardFmi(idx, opt, fm=build_fm_index(code), device="cpu")
        mp = pytest.MonkeyPatch()
        mp.setattr(fmi_search, "_on_cuda", lambda x: True)
        request.addfinalizer(mp.undo)
    se = []
    for i in range(3 * LANES):
        st = int(rng.integers(0, n - 151))
        c = idx.text[st: st + 151].copy()
        c[int(rng.integers(0, 151))] ^= 1
        if i % 2:
            c = (3 - c[::-1]).astype(np.uint8)
        se.append(Read(f"s{i}", _seq(c), "I" * 151, None))
    pe = []
    for i in range(40):
        p = int(rng.integers(0, n - 500))
        r1 = idx.text[p: p + 100].copy()
        r2 = (3 - idx.text[p + 200: p + 300][::-1]).astype(np.uint8)
        if i % 10 == 9:
            r2[0:100:11] = (r2[0:100:11] + 1) % 4
        pe += [Read(f"p{i}", _seq(r1), "I" * 100, None),
               Read(f"p{i}", _seq(r2), "I" * 100, None)]
    return idx, opt, engine, se, pe


def _align(setup, kind):
    """(SAM blocks, TPROF totals, counts, wall seconds, batches) of one run
    of a fresh Aligner."""
    idx, opt, engine, se, pe = setup
    if kind == "pe":
        opt = MemOptions(flag=opt.flag | MEM_F_PE)
    al = Aligner(idx, opt, seeding_engine=engine, device="cpu")
    TPROF.totals.clear()
    TPROF.counts.clear()
    t0 = time.perf_counter()
    if kind == "se":
        batches = [se[i: i + LANES] for i in range(0, len(se), LANES)]
        sam = [b for blocks in al.align_stream(iter(batches)) for b in blocks]
    else:
        sam = al.align_pairs(pe)
    wall = time.perf_counter() - t0
    n = len(se) if kind == "se" else len(pe)
    lanes = LANES if kind == "se" else engine.lanes or n
    return sam, dict(TPROF.totals), dict(TPROF.counts), wall, -(-n // lanes)


@pytest.fixture(scope="module")
def runs(setup):
    return {kind: _align(setup, kind) for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_every_new_span_is_present(runs, kind):
    _, totals, counts, _, _ = runs[kind]
    for name in NEW[kind] + (SPANNED,):
        assert name in totals, name
    assert all(counts[name] > 0 for name in NEW[kind])
    assert "gc" not in totals       # an untraced run hooks no collection


@pytest.mark.parametrize("kind", KINDS)
def test_spans_nest_inside_their_stage(runs, kind):
    _, t, _, _, _ = runs[kind]
    fin = "finalize" if kind == "se" else "pe.finalize"
    assert t["finalize.native"] <= t[fin]
    assert t["extend.native"] + t["extend.fetch"] <= (
        t["extend.submit"] + t["extend.finish"])
    assert t["seed.fetch"] <= t["seed.finish"]
    if kind == "pe":
        assert t["pair.native"] + t["pair.fetch"] <= (
            t["pe.dedup"] + t["pe.rescue"])


@pytest.mark.parametrize("kind", KINDS)
def test_spanned_is_the_outermost_stages(runs, kind):
    _, t, _, wall, _ = runs[kind]
    assert t[SPANNED] == pytest.approx(sum(t[k] for k in OUTER[kind]),
                                       rel=1e-9)
    assert t[SPANNED] <= wall


@pytest.mark.parametrize("kind", KINDS)
def test_span_counts_follow_batches_not_reads(runs, kind):
    """A span a batch or chunk (a readback or C++ call a round or a side at
    most), never one a read or region."""
    _, _, c, _, batches = runs[kind]
    chunks = 1 if kind == "pe" else batches     # align_pairs: one chunk
    assert c["encode"] == chunks
    # PE: its retry inside the span; SE: the plan, then the host's CIGARs
    # and the emit (align/finalize_split.py)
    assert c["finalize.native"] == (2 if kind == "se" else 1) * chunks
    assert c["extend.native"] == 2 * batches    # prepare and finalize
    assert c["extend.fetch"] <= 3 * batches     # round 1 and two retries
    assert c["seed.fetch"] <= 3 * batches
    if kind == "pe":
        assert c["pair.native"] == batches
        assert c["pair.fetch"] == 1             # one rescue call a chunk
    assert 3 * batches < LANES


@pytest.mark.parametrize("kind", KINDS)
def test_region_objects_only_for_pairs(runs, kind):
    """``extend.objects`` (RegTable.to_lists, an AlnReg a region) runs
    inside ``extend.finish`` once a lane batch of a paired-end chunk, for
    the dedup and pairing, and never in a single-end stream through the
    flat path, whose finalize reads the region table's arrays."""
    _, t, c, _, batches = runs[kind]
    if kind == "se":
        assert "extend.objects" not in c
    else:
        assert c["extend.objects"] == batches
        assert t["extend.objects"] <= t["extend.finish"]


def test_split_finalize_spans_once_a_batch(setup, runs, monkeypatch):
    """The single-end finalize with its CIGARs on the device (here the
    kernel's plain version in the card's step): ``finalize.cigar``
    (upload, launch, readback) once a batch in ``finalize`` and outside
    ``finalize.native``, which times the plan and then the host's share
    and the emit, twice a batch; ``finalize.cigar_host`` inside the second.
    No job is left to the host here, and the SAM is the CPU's, where the
    host aligns every job."""
    monkeypatch.setattr(sw_global, "cigars", sw_global.align_jobs)
    sw_global.stats.reset()
    sam, t, c, _, batches = _align(setup, "se")
    assert sam == runs["se"][0]
    assert c["finalize.cigar"] == c["finalize.cigar_host"] == batches
    assert c["finalize.native"] == 2 * batches
    assert t["finalize.cigar_host"] <= t["finalize.native"]
    assert t["finalize.native"] + t["finalize.cigar"] <= t["finalize"]
    assert sw_global.stats.jobs >= len(setup[3]) and sw_global.stats.host == 0


def test_split_finalize_counts_the_jobs_it_leaves_to_the_host(
        setup, runs, monkeypatch):
    """No CIGAR run fits a job's output row: the kernel flags every job,
    the host runs each one, the counter says so, and the SAM is the
    same."""
    monkeypatch.setattr(sw_global, "cigars", sw_global.align_jobs)
    monkeypatch.setattr(sw_global, "SLOTS", 0)
    sw_global.stats.reset()
    sam, _, c, _, batches = _align(setup, "se")
    assert sam == runs["se"][0]
    assert sw_global.stats.host == sw_global.stats.jobs >= len(setup[3])
    assert c["finalize.cigar_host"] == batches


def test_cpu_finalize_leaves_every_job_to_the_host(setup, runs):
    """On the CPU the card's step flags every job: the host's span runs
    once a batch and counts them all, with the same spans around it."""
    sw_global.stats.reset()
    sam, t, c, _, batches = _align(setup, "se")
    assert sam == runs["se"][0]
    assert c["finalize.cigar"] == c["finalize.cigar_host"] == batches
    assert t["finalize.native"] + t["finalize.cigar"] <= t["finalize"]
    assert sw_global.stats.host == sw_global.stats.jobs >= len(setup[3])


def test_outgrown_pack_is_timed_as_unpacked(setup, runs, monkeypatch):
    """A batch with more SMEMs than the packed buffer holds (here one entry
    a read) is fetched as its whole slot planes under ``seed.unpacked``,
    nested in ``seed.finish``, each readback (the pack, then the planes)
    under ``seed.fetch``; the SAM is the packed path's. A stream that fits
    the pack never enters the stage."""
    engine = setup[2]
    monkeypatch.setattr(engine, "pack_cap_per_read", 1)
    sam, t, c, _, batches = _align(setup, "se")
    assert sam == runs["se"][0]
    assert c["seed.unpacked"] == batches
    assert t["seed.unpacked"] <= t["seed.finish"]
    name = "fmi" if isinstance(engine, FmiDeviceEngine) else "learned"
    assert c["seed.fetch"] == UNPACKED_FETCHES[name] * batches
    assert "seed.unpacked" not in runs["se"][2]


def test_io_parse_leaves_out_the_consumer(tmp_path):
    """read_chunks times each chunk's parse, not a consumer that sleeps
    50 ms between chunks; at no stage's depth it is all of ``spanned``."""
    rng = np.random.default_rng(5)
    path = tmp_path / "r.fq"
    with open(path, "w") as f:
        for i in range(200):
            f.write(f"@r{i}\n{_seq(rng.integers(0, 4, 100))}\n+\n"
                    f"{'I' * 100}\n")
    TPROF.totals.clear()
    TPROF.counts.clear()
    n_chunks = n_reads = 0
    t0 = time.perf_counter()
    for chunk in fastq.read_chunks(str(path), None, 5000):
        n_chunks += 1
        n_reads += len(chunk)
        time.sleep(0.05)
    wall = time.perf_counter() - t0
    assert n_reads == 200 and n_chunks == 4
    # the last call only finds the end
    assert TPROF.counts["io.parse"] == n_chunks + 1
    assert wall >= 4 * 0.05 and TPROF.totals["io.parse"] < 0.05
    assert TPROF.totals[SPANNED] == TPROF.totals["io.parse"]


def test_gc_is_timed_only_while_traced(tmp_path):
    before = list(gc.callbacks)
    TPROF.totals.clear()
    TPROF.counts.clear()
    gc.collect()
    assert "gc" not in TPROF.totals
    prof = timer.start_trace(str(tmp_path), cuda=False)
    try:
        gc.collect()
        gc.collect()
    finally:
        timer.stop_trace(prof)
    assert gc.callbacks == before
    assert TPROF.counts["gc"] >= 2 and TPROF.totals["gc"] > 0
    assert SPANNED not in TPROF.totals          # gc overlaps the stages
    n = TPROF.counts["gc"]
    gc.collect()
    assert TPROF.counts["gc"] == n


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["no_spans", "traced"])
def test_sam_is_the_same_with_and_without_spans(setup, runs, kind, mode,
                                                tmp_path, monkeypatch):
    if mode == "no_spans":
        monkeypatch.setattr(timer.StageTimer, "stage",
                            lambda self, name: contextlib.nullcontext())
        sam = _align(setup, kind)[0]
    else:
        prof = timer.start_trace(str(tmp_path), cuda=False)
        try:
            sam = _align(setup, kind)[0]
        finally:
            timer.stop_trace(prof)
    assert sam == runs[kind][0]


def test_stage_timer_depth_and_spanned():
    """Nested stages count once toward ``spanned``; a stage left by an
    exception closes; report() prints ``spanned`` on its own line."""
    import io

    tm = timer.StageTimer()
    with tm.stage("a"):
        with tm.stage("a.b"):
            time.sleep(0.002)
    with pytest.raises(KeyError):
        with tm.stage("c"):
            with tm.stage("c.d"):
                raise KeyError
    assert tm.depth == 0
    assert tm.totals[SPANNED] == pytest.approx(tm.totals["a"] + tm.totals["c"])
    assert tm.totals["a"] >= tm.totals["a.b"] >= 0.002
    buf = io.StringIO()
    tm.report(buf)
    lines = buf.getvalue().splitlines()
    assert lines[-1].split()[1] == SPANNED
    assert not any(SPANNED in ln for ln in lines[:-1])
    total = next(ln for ln in lines if ln.split()[1] == "total")
    assert float(total.split()[2][:-1]) == pytest.approx(
        sum(tm.totals[k] for k in ("a", "a.b", "c", "c.d")), abs=0.01)
