"""The single-end finalize split around the card's CIGAR kernel
(align/finalize_split.py: the C++ plan, the card's step, the host's share
of the CIGARs, the C++ emit) writes the SAM that finalize_se_c writes, byte
for byte: under the option sets of tests/test_native_finalize.py, over
reads with XA hits, ALT contigs, reverse strands, chimeras, deletions and
clipped ends; with every region's band ladder forced to run on; over 800 bp
reads, whose jobs pass a warp's shared memory; over an empty batch and one
with no region. The card's step is the kernel's plain version
(sw_global.align_jobs), or, as the Aligner runs it on the CPU, every job
flagged for the host (sw_global.cigars)."""

import copy

import numpy as np
import pytest
import torch

from bwameme_tpu_torch.align import finalize_split, native
from bwameme_tpu_torch.align.extend import RegTable
from bwameme_tpu_torch.index import bntseq
from bwameme_tpu_torch.index.build import build_index
from bwameme_tpu_torch.io.fastq import Read
from bwameme_tpu_torch.ops import sw_global
from bwameme_tpu_torch.pipeline import Aligner
from bwameme_tpu_torch.utils.config import (MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ,
                                            MEM_F_NO_MULTI, MEM_F_PRIMARY5,
                                            MEM_F_SOFTCLIP, MemOptions,
                                            fill_scmat)

OPTS = [
    {},  # defaults
    {"flag": MEM_F_ALL},
    {"flag": MEM_F_SOFTCLIP},
    {"flag": MEM_F_NO_MULTI},
    {"flag": MEM_F_PRIMARY5 | MEM_F_KEEP_SUPP_MAPQ},
    {"T": 40},
    {"a": 2, "b": 8, "o_del": 12, "o_ins": 10, "e_del": 3, "e_ins": 2,
     "T": 17},
]
IDS = ["default", "all", "softclip", "no_multi", "primary5_supp", "T40",
       "scoring_T17"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(codes) -> str:
    return "".join("ACGTN"[c] for c in codes)


@pytest.fixture(scope="module")
def world():
    """A primary contig and an ALT contig sharing a repeat, a tandem array,
    and 151 bp reads from both strands: substitutions, a 2-3 base indel,
    chimeras, reads from the shared repeat (XA hits, ALT hits), deletions,
    clipped ends, an N, and one read of random bases."""
    rng = np.random.default_rng(2020)
    n1, n2 = 24000, 9000
    code = rng.integers(0, 4, n1 + n2).astype(np.uint8)
    code[4000:4800] = code[12000:12800]
    code[n1 + 2000: n1 + 2800] = code[12000:12800]
    code[20000:20300] = np.tile(code[20000:20050], 6)
    contigs = [bntseq.Contig("chrA", "", 0, n1, 0),
               bntseq.Contig("chrB_alt", "", n1, n2, 0, is_alt=True)]
    bns = bntseq.BntSeq(l_pac=n1 + n2, contigs=contigs, ambs=[], code=code)
    idx = build_index(bns, rmi_bits=10)
    text = idx.text
    reads = []
    for i in range(48):
        st = int(rng.integers(0, idx.l_pac - 160))
        c = text[st: st + 151].copy()
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, 151))
            c[p] = (c[p] + rng.integers(1, 4)) % 4
        if i % 4 == 1:     # a 2-base deletion
            p = int(rng.integers(20, 130))
            c = np.concatenate([c[:p], text[st + p + 2: st + 153]])
        elif i % 4 == 2:   # a 3-base insertion
            p = int(rng.integers(20, 130))
            c = np.concatenate([c[:p], rng.integers(0, 4, 3), c[p:148]])
        if i % 6 == 5:     # a chimera
            st2 = int(rng.integers(0, idx.l_pac - 80))
            c = np.concatenate([c[:75], text[st2: st2 + 76]])
        if i % 9 == 4:
            c[int(rng.integers(0, 151))] = 4
        if i % 3 == 0:
            c = np.where(c < 4, 3 - c, 4)[::-1]
        reads.append(Read(f"r{i:03d}", _seq(c.astype(np.uint8)),
                          "".join(chr(33 + int(q))
                                  for q in rng.integers(2, 40, len(c))),
                          "BC:Z:ACGT" if i % 7 == 0 else None))
    for i, st in enumerate((12050, 12200, 12400, 12600, 4100, 20010)):
        # the shared repeat and the tandem array: XA and ALT hits
        c = text[st: st + 151].copy()
        c[50 + i] = (c[50 + i] + 1) % 4
        if i % 2:
            c = (3 - c[::-1]).astype(np.uint8)
        reads.append(Read(f"rep{i}", _seq(c), "I" * 151, None))
    for i, (head, gap) in enumerate(((50, 3), (70, 25), (90, 40))):
        st = int(rng.integers(0, n1 - 400))
        c = np.concatenate([text[st: st + head],
                            text[st + head + gap: st + gap + 151]])
        reads.append(Read(f"del{i}", _seq(c), "I" * 151, None))
    reads.append(Read("junk", _seq(rng.integers(0, 4, 151)), "I" * 151,
                      None))
    return idx, reads


def _regions(idx, opt, reads, rg_id=None):
    al = Aligner(idx, opt, rg_id=rg_id, copy_comment=True, device="cpu")
    recs = al.encode(reads)
    return al, recs, al.regions(recs)


def _both(idx, opt, al, recs, regs, n_processed=0, card="plain"):
    """(split, finalize_se_c) SAM blocks of the batch, and the split's
    counts of jobs and of jobs the host ran. ``card``: "plain", the
    kernel's plain version in the card's step; "host", the CPU's step."""
    sw_global.stats.reset()
    with pytest.MonkeyPatch.context() as mp:
        if card == "plain":
            mp.setattr(sw_global, "cigars", sw_global.align_jobs)
        got = finalize_split.finalize_se_split(
            opt, idx.bns, idx.text, al.text.text32, recs,
            copy.deepcopy(regs), al.rg_id, n_processed)
    counts = (sw_global.stats.jobs, sw_global.stats.host)
    want = native.finalize_se_native(opt, idx.bns, idx.text, recs, regs,
                                     al.rg_id, n_processed)
    return got, want, counts


@pytest.mark.parametrize("ov", OPTS, ids=IDS)
def test_split_sam_is_finalize_se_c(world, ov):
    idx, reads = world
    opt = MemOptions(**ov)
    if {"a", "b"} & set(ov):
        opt.mat = fill_scmat(opt.a, opt.b)
    al, recs, regs = _regions(idx, opt, reads,
                              "rg7" if ov.get("T") else None)
    assert isinstance(regs, RegTable)
    got, want, (jobs, _) = _both(idx, opt, al, recs, regs, 1000)
    assert got == want
    assert jobs >= len(reads) - 1
    sam = "".join(got)
    assert "chrB_alt" in sam and "\t16\t" in sam
    if not ov.get("flag", 0) & MEM_F_ALL:
        assert "\tXA:Z:" in sam


@pytest.mark.parametrize("ov", OPTS, ids=IDS)
def test_cpu_split_sam_is_finalize_se_c(world, ov):
    """The CPU's step flags every job and the host aligns each: the SAM is
    still finalize_se_c's."""
    idx, reads = world
    opt = MemOptions(**ov)
    if {"a", "b"} & set(ov):
        opt.mat = fill_scmat(opt.a, opt.b)
    al, recs, regs = _regions(idx, opt, reads,
                              "rg7" if ov.get("T") else None)
    got, want, (jobs, host) = _both(idx, opt, al, recs, regs, 1000, "host")
    assert got == want
    assert host == jobs >= len(reads) - 1


def test_split_sam_with_the_band_ladder_forced(world):
    """Every region's truesc raised past what its first band can reach:
    the card's first score starts reg2aln's ladder, which the host runs on
    from the second band, for every job (or the whole ladder, for the jobs
    the kernel flagged). The SAM is still finalize_se_c's."""
    idx, reads = world
    opt = MemOptions()
    al, recs, regs = _regions(idx, opt, reads)
    lists = regs.to_lists()
    for r in (a for rs in lists for a in rs):
        r.truesc += 40
    got, want, (jobs, host) = _both(idx, opt, al, recs, lists)
    assert got == want
    assert jobs > 0 and host == jobs


def _long_reads(idx, rng, n):
    """n reads of 800 bp with substitutions and a 5-base deletion."""
    out = []
    for i in range(n):
        st = int(rng.integers(0, 24000 - 900))
        c = idx.text[st: st + 805].copy()
        c = np.concatenate([c[:300], c[305:]])
        for p in rng.integers(0, 800, 8):
            c[p] = (c[p] + 1) % 4
        if i % 2:
            c = (3 - c[::-1]).astype(np.uint8)
        out.append(Read(f"long{i}", _seq(c), "I" * 800, None))
    return out


def test_split_sam_on_800bp_reads(world):
    """800 bp reads take the dataclass path of extension; their jobs pass
    a warp's slice, so the host aligns them, and the 151 bp reads beside
    them stay on the kernel."""
    idx, reads = world
    opt = MemOptions()
    batch = _long_reads(idx, np.random.default_rng(8), 4) + reads[:8]
    al, recs, regs = _regions(idx, opt, batch)
    assert isinstance(regs, list)
    got, want, (jobs, host) = _both(idx, opt, al, recs, regs)
    assert got == want
    assert 4 <= host < jobs
    assert all("\t" in block for block in got[:4])


def test_split_sam_of_an_empty_batch_and_of_no_region(world):
    idx, reads = world
    opt = MemOptions()
    al, recs, regs = _regions(idx, opt, reads[-1:])      # the junk read
    got, want, (jobs, host) = _both(idx, opt, al, recs, regs)
    assert got == want and jobs == host == 0
    assert got[0].split("\t")[1] == "4"
    got, want, (jobs, _) = _both(idx, opt, al, [], [])
    assert got == want == [] and jobs == 0


def _stream(world, card):
    """The Aligner's single-end stream over two batches, finalize_se_c's
    SAM of each batch, and the split's counts of jobs and host jobs."""
    idx, reads = world
    opt = MemOptions()
    batches = [reads[:20], reads[20:]]
    want, ref = [], Aligner(idx, opt, device="cpu")
    for batch in batches:
        recs = ref.encode(batch)
        regs = ref.regions(recs)
        want += native.finalize_se_native(opt, idx.bns, idx.text, recs,
                                          regs, None, len(want))
    sw_global.stats.reset()
    with pytest.MonkeyPatch.context() as mp:
        if card == "plain":
            mp.setattr(sw_global, "cigars", sw_global.align_jobs)
        al = Aligner(idx, opt, device="cpu")
        got = [b for blocks in al.align_stream(iter(batches))
               for b in blocks]
    return got, want, (sw_global.stats.jobs, sw_global.stats.host)


def test_aligner_stream_through_the_split(world):
    """The Aligner on the CPU finalizes every batch through the split, the
    host aligning every job, and writes finalize_se_c's SAM."""
    got, want, (jobs, host) = _stream(world, "host")
    assert got == want
    assert host == jobs > 0


def test_aligner_stream_through_the_plain_kernel(world):
    """With the kernel's plain version in the card's step, as the kernel
    is on CUDA, the stream's SAM is the same and the card's step aligns
    most jobs."""
    got, want, (jobs, host) = _stream(world, "plain")
    assert got == want
    assert 2 * host < jobs
