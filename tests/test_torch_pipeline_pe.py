"""The port's paired-end pipeline on the CPU against the JAX package: the
cases of tests/test_pipeline_pe.py (proper pairs, mate rescue, one end
unmapped, batched rescue == serial rescue) through bwameme_tpu_torch's
Aligner, whose SAM must also equal bwameme_tpu's Aligner's on the same
pairs, byte for byte. The host engine takes the reference's serial per-pair
rescue; the device engine (plain versions on the CPU) the batched rescue
through the full-SW kernel's coordinate form and the C++ pair finalization.
"""

import numpy as np
import pytest
import torch

from bwameme_tpu.index import bntseq
from bwameme_tpu.index.build import build_index
from bwameme_tpu.io.fastq import Read
from bwameme_tpu.pipeline import Aligner as JaxAligner
from bwameme_tpu_torch.io.sam import (
    FLAG_MREVERSE, FLAG_PAIRED, FLAG_PROPER_PAIR, FLAG_READ1, FLAG_READ2,
    FLAG_REVERSE, FLAG_UNMAP,
)
from bwameme_tpu_torch.ops import launch
from bwameme_tpu_torch.pipeline import Aligner
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.utils.config import MEM_F_PE, MemOptions


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(321)
    n = 50000
    code = rng.integers(0, 4, n).astype(np.uint8)
    bns = bntseq.BntSeq(
        l_pac=n, contigs=[bntseq.Contig("chrP", "", 0, n, 0)], ambs=[],
        code=code)
    idx = build_index(bns, rmi_bits=11)
    opt = MemOptions()
    opt.flag |= MEM_F_PE
    return idx, opt, rng


@pytest.fixture(scope="module")
def engine(setup):
    """One device engine on the CPU for the module (the plain rounds)."""
    idx, opt, _ = setup
    return DeviceSeedingEngine(idx, opt, lanes=64, device="cpu")


def make_pairs(idx, rng, n_pairs, isize_mean=300, isize_sd=25, rlen=100,
               mut=0.005):
    """FR pairs: R1 forward at p, R2 = RC of [p+isize-rlen, p+isize)."""
    reads, truths = [], []
    for i in range(n_pairs):
        isize = int(rng.normal(isize_mean, isize_sd))
        p = int(rng.integers(0, idx.l_pac - isize - rlen - 2))
        r1 = idx.text[p: p + rlen].copy()
        r2f = idx.text[p + isize - rlen: p + isize].copy()
        for arr in (r1, r2f):
            for j in range(rlen):
                if rng.random() < mut:
                    arr[j] = (arr[j] + rng.integers(1, 4)) % 4
        r2 = (3 - r2f[::-1]).astype(np.uint8)
        q = "I" * rlen
        reads.append(Read(f"pair{i}", "".join("ACGT"[c] for c in r1), q, None))
        reads.append(Read(f"pair{i}", "".join("ACGT"[c] for c in r2), q, None))
        truths.append((p, p + isize - rlen, isize))
    return reads, truths


def _parse_all(blocks):
    recs = []
    for b in blocks:
        for line in b.strip("\n").split("\n"):
            f = line.split("\t")
            recs.append(dict(qname=f[0], flag=int(f[1]), rname=f[2],
                             pos=int(f[3]), mapq=int(f[4]), cigar=f[5],
                             rnext=f[6], pnext=int(f[7]), tlen=int(f[8])))
    return recs


def _aligned(setup, engine, reads, batched=None):
    """The port's SAM blocks, the same from the host engine (serial rescue)
    and the device engine (batched rescue), and equal to bwameme_tpu's."""
    idx, opt, _ = setup
    want = JaxAligner(idx, opt).align_pairs(reads)
    host = Aligner(idx, opt, device="cpu", batched_rescue=batched)
    assert host.align_pairs(reads) == want
    dev = Aligner(idx, opt, seeding_engine=engine, device="cpu")
    assert dev.batched_rescue
    assert dev.align_pairs(reads) == want
    assert launch.stats.launches["sw_full"] == 0     # plain versions only
    return want


def test_proper_pairs(setup, engine):
    idx, _, rng = setup
    reads, truths = make_pairs(idx, rng, 40)
    recs = _parse_all(_aligned(setup, engine, reads))
    primary = [r for r in recs if not (r["flag"] & 0x900)]
    assert len(primary) == 80
    n_proper = sum(1 for r in primary if r["flag"] & FLAG_PROPER_PAIR)
    assert n_proper >= 70, n_proper
    by_name = {}
    for r in primary:
        by_name.setdefault(r["qname"], []).append(r)
    for i, (p1, p2, isize) in enumerate(truths[:10]):
        rs = by_name[f"pair{i}"]
        assert len(rs) == 2
        r1 = next(r for r in rs if r["flag"] & FLAG_READ1)
        r2 = next(r for r in rs if r["flag"] & FLAG_READ2)
        assert r1["pos"] == p1 + 1, (i, r1)
        assert r2["pos"] == p2 + 1, (i, r2)
        assert r1["flag"] & FLAG_MREVERSE
        assert r2["flag"] & FLAG_REVERSE
        assert r1["rnext"] == "="
        assert r1["tlen"] == isize
        assert r2["tlen"] == -isize


def test_mate_rescue(setup, engine):
    """R2 of the last pair mutated every 11th base: no 19-mer seed, so only
    the rescue SW places it."""
    idx, _, rng = setup
    reads, truths = make_pairs(idx, rng, 12)
    r2 = reads[-1]
    c = np.array(["ACGT".index(x) for x in r2.seq], np.uint8)
    c[0:100:11] = (c[0:100:11] + 1) % 4
    reads[-1] = Read(r2.name, "".join("ACGT"[x] for x in c), r2.qual, None)
    recs = _parse_all(_aligned(setup, engine, reads))
    last = [r for r in recs if r["qname"] == f"pair{len(truths) - 1}"
            and not (r["flag"] & 0x900)]
    r2rec = next(r for r in last if r["flag"] & FLAG_READ2)
    assert not (r2rec["flag"] & FLAG_UNMAP), r2rec
    assert abs(r2rec["pos"] - (truths[-1][1] + 1)) <= 5, r2rec


def test_one_end_unmapped(setup, engine):
    idx, _, rng = setup
    reads, truths = make_pairs(idx, rng, 11)
    garbage = "".join("ACGT"[c] for c in rng.integers(0, 4, 100))
    reads[-1] = Read(reads[-1].name, garbage, "I" * 100, None)
    recs = _parse_all(_aligned(setup, engine, reads))
    last = [r for r in recs if r["qname"] == f"pair{len(truths) - 1}"]
    r2rec = next(r for r in last if r["flag"] & FLAG_READ2)
    assert r2rec["flag"] & FLAG_PAIRED
    if r2rec["flag"] & FLAG_UNMAP:
        r1rec = next(r for r in last if r["flag"] & FLAG_READ1)
        assert r2rec["rname"] != "*" or r1rec["flag"] & FLAG_UNMAP


def test_batched_mate_rescue_matches_serial(setup, engine):
    """The batched rescue (the coordinate form of the full SW, then the C++
    pair finalization) gives the serial path's SAM on a chunk without
    cascading rescues, on the host engine as on the device engine."""
    idx, opt, rng = setup
    reads = []
    n = idx.l_pac
    for i in range(6):
        pos = int(rng.integers(200, n - 700))
        isize = int(rng.integers(250, 400))
        c1 = idx.text[pos: pos + 100].copy()
        c2 = (3 - idx.text[pos + isize - 100: pos + isize][::-1]).astype(
            np.uint8)
        if i % 3 == 0:
            c2[10:90:7] = (c2[10:90:7] + 1) % 4
        reads.append(Read(f"p{i}", "".join("ACGT"[x] for x in c1), "I" * 100,
                          None))
        reads.append(Read(f"p{i}", "".join("ACGT"[x] for x in c2), "I" * 100,
                          None))
    serial = Aligner(idx, opt, device="cpu", batched_rescue=False)
    assert _aligned(setup, engine, reads, batched=True) == serial.align_pairs(
        reads)
    dev_serial = Aligner(idx, opt, seeding_engine=engine, device="cpu",
                         batched_rescue=False)
    assert dev_serial.align_pairs(reads) == serial.align_pairs(reads)


def test_device_engine_pairs_in_several_batches(setup, engine):
    """A chunk of 100 pairs through the 64 lanes of the engine: four
    batches, seed(k+1) submitted between extend(k)'s launch and finish; the
    insert-size statistics stay the chunk's, so the SAM is that of one
    batch; odd read counts are refused."""
    idx, opt, rng = setup
    reads, _ = make_pairs(idx, rng, 100, mut=0.01)
    one = DeviceSeedingEngine(idx, opt, lanes=len(reads), device="cpu")
    whole = Aligner(idx, opt, seeding_engine=one, device="cpu")
    parts = Aligner(idx, opt, seeding_engine=engine, device="cpu")
    assert parts.align_pairs(reads) == whole.align_pairs(reads)
    with pytest.raises(ValueError, match="in pairs"):
        parts.align_pairs(reads[:3])
