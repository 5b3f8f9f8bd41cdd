"""The flat extension path's hand-off to the single-end finalize: the port's
Aligner on the CPU gives the same SAM, byte for byte, when finalize_se_c
reads the regions straight from extension's arrays (extend.RegTable) and
when it reads the AlnReg lists that RegTable.to_lists builds from them (the
hand-off of the dataclass path). Under the option sets of
tests/test_native_finalize.py, with a read group, over a batch that holds a
read with no region, a purged region (qb == qe == -1) and a read on an ALT
contig."""

import numpy as np
import pytest
import torch

from bwameme_tpu_torch.align import native
from bwameme_tpu_torch.align.extend import AlnReg, RegTable
from bwameme_tpu_torch.index import bntseq
from bwameme_tpu_torch.index.build import build_index
from bwameme_tpu_torch.io.fastq import Read
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


@pytest.fixture(scope="module")
def world():
    """A primary contig and an ALT contig that share a repeat, and 151 bp
    reads (the flat path) from both strands: single mismatches (two seeds of
    one chain, the second purged), chimeras, comments, reads from the ALT
    contig and from the shared repeat, deletions, mismatches near an end,
    and one read of random bases (no seed, no region)."""
    rng = np.random.default_rng(1818)
    n1, n2 = 24000, 9000
    code = rng.integers(0, 4, n1 + n2).astype(np.uint8)
    code[4000:4800] = code[12000:12800]
    code[n1 + 2000: n1 + 2800] = code[12000:12800]
    code[20000:20300] = np.tile(code[20000:20050], 6)
    contigs = [bntseq.Contig("chrA", "", 0, n1, 0),
               bntseq.Contig("chrB_alt", "", n1, n2, 0, is_alt=True)]
    bns = bntseq.BntSeq(l_pac=n1 + n2, contigs=contigs, ambs=[], code=code)
    idx = build_index(bns, rmi_bits=10)
    reads = []
    for i in range(40):
        st = (int(rng.integers(n1, n1 + n2 - 152)) if i % 5 == 0
              else int(rng.integers(0, idx.l_pac - 152)))
        c = idx.text[st: st + 151].copy()
        p = int(rng.integers(40, 110))
        c[p] = (c[p] + rng.integers(1, 4)) % 4
        if i % 6 == 1:
            st2 = int(rng.integers(0, idx.l_pac - 80))
            c = np.concatenate([c[:75], idx.text[st2: st2 + 76]])
        if i % 3 == 0:
            c = (3 - c[::-1]).astype(np.uint8)
        reads.append(Read(name=f"r{i:03d}",
                          seq="".join("ACGT"[x] for x in c),
                          qual="".join(chr(33 + int(q))
                                       for q in rng.integers(2, 40, 151)),
                          comment="BC:Z:ACGT" if i % 7 == 0 else None))
    for i, (head, gap) in enumerate(((50, 3), (70, 25), (90, 40))):
        # deletions: the CIGAR's band comes from each region's truesc and w
        st = int(rng.integers(0, n1 - 400))
        reads.append(Read(name=f"del{i}", comment=None, qual="I" * 151,
                          seq="".join("ACGT"[x] for x in np.concatenate(
                              [idx.text[st: st + head],
                               idx.text[st + head + gap: st + gap + 151]]))))
    for i in range(3):
        # a mismatch near an end: clipped, so truesc is not the score
        st = int(rng.integers(0, n1 - 200))
        c = idx.text[st: st + 151].copy()
        p = (2, 148, 4)[i]
        c[p] = (c[p] + 1) % 4
        reads.append(Read(name=f"end{i}", comment=None, qual="I" * 151,
                          seq="".join("ACGT"[x] for x in c)))
    for i, st in enumerate((12100, 12300, 12550)):
        # from the repeat the ALT contig shares: a primary hit and an ALT
        # hit, which mark_primary and MAPQ tell apart by is_alt alone
        c = idx.text[st: st + 151].copy()
        c[60 + i] = (c[60 + i] + 1) % 4
        if i == 1:
            c = (3 - c[::-1]).astype(np.uint8)
        reads.append(Read(name=f"alt{i}", comment=None, qual="I" * 151,
                          seq="".join("ACGT"[x] for x in c)))
    reads.append(Read(name="junk", comment=None, qual="I" * 151,
                      seq="".join("ACGT"[x] for x in
                                  rng.integers(0, 4, 151))))
    return idx, reads


@pytest.mark.parametrize("ov", OPTS, ids=IDS)
def test_table_and_lists_give_one_sam(world, ov):
    idx, reads = world
    opt = MemOptions(**ov)
    if {"a", "b"} & set(ov):
        opt.mat = fill_scmat(opt.a, opt.b)
    al = Aligner(idx, opt, rg_id="rg7", copy_comment=True, device="cpu")
    recs = al.encode(reads)
    table = al.regions(recs)
    assert isinstance(table, RegTable)
    assert len(table.off) == len(reads) + 1
    assert table.off[-1] == len(table.rb)
    assert (np.diff(table.off) == 0).any()                 # no region
    assert ((table.qb == -1) & (table.qe == -1)).any()     # purged
    assert table.is_alt.any() and not table.is_alt.all()   # ALT contig
    lists = table.to_lists()
    assert [len(r) for r in lists] == np.diff(table.off).tolist()
    assert all(type(a) is AlnReg for r in lists for a in r)
    # what finalize_se_c reads: the same columns, dtypes and offsets
    cols, want_cols = native._reg_columns(table), native._reg_columns(lists)
    assert cols.keys() == want_cols.keys()
    for k, v in want_cols.items():
        assert cols[k].dtype == v.dtype and cols[k].flags.c_contiguous, k
        np.testing.assert_array_equal(cols[k], v, err_msg=k)

    got = al.sam_se(recs, table, 0)
    want = al.sam_se(recs, lists, 0)
    assert got == want
    assert any("chrB_alt" in block for block in got)
    assert all("\tRG:Z:rg7" in block for block in got)


def test_empty_table_gives_unmapped_reads(world):
    """The table of a batch with no region: offsets all zero, every column
    empty. It builds no AlnReg, and finalize writes each read unmapped, as
    it does from empty lists."""
    idx, reads = world
    al = Aligner(idx, MemOptions(), device="cpu")
    recs = al.encode(reads[:3])
    table = al.regions(recs)
    empty = RegTable(off=np.zeros(4, np.int32),
                     **{k: getattr(table, k)[:0] for k in RegTable.COLUMNS},
                     is_alt=table.is_alt[:0])
    assert empty.to_lists() == [[], [], []]
    got = al.sam_se(recs, empty, 0)
    assert got == al.sam_se(recs, [[], [], []], 0)
    assert all(block.split("\t")[1] == "4" for block in got)
