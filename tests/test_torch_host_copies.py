"""The port keeps its own copy of the host modules it uses, under the same
sub-package and file names as bwameme_tpu. One cheap parity check per copy,
so that a later drift between the two shows."""

import copy
import dataclasses
import io as _io
import os
import subprocess
import sys

import numpy as np
import pytest

import bwameme_tpu.align.alt as j_alt
import bwameme_tpu.align.chain as j_chain
import bwameme_tpu.align.extend as j_extend
import bwameme_tpu.align.finalize as j_finalize
import bwameme_tpu.align.native as j_native
import bwameme_tpu.align.pairing as j_pairing
import bwameme_tpu.align.sw_scalar as j_sw
import bwameme_tpu.index.bntseq as j_bntseq
import bwameme_tpu.index.build as j_build
import bwameme_tpu.index.ert as j_ert
import bwameme_tpu.index.fmindex as j_fmindex
import bwameme_tpu.index.packing as j_packing
import bwameme_tpu.index.suffix_array as j_sa
import bwameme_tpu.io.fastq as j_fastq
import bwameme_tpu.io.sam as j_sam
import bwameme_tpu.models.prmi as j_prmi
import bwameme_tpu.seeding.fmi_engine as j_fmi_engine
import bwameme_tpu.seeding.host_engine as j_host
import bwameme_tpu.utils.config as j_config
import bwameme_tpu.utils.timer as j_timer
import bwameme_tpu_torch.align.alt as t_alt
import bwameme_tpu_torch.align.chain as t_chain
import bwameme_tpu_torch.align.finalize as t_finalize
import bwameme_tpu_torch.align.native as t_native
import bwameme_tpu_torch.align.pairing as t_pairing
import bwameme_tpu_torch.align.sw_scalar as t_sw
import bwameme_tpu_torch.index.bntseq as t_bntseq
import bwameme_tpu_torch.index.build as t_build
import bwameme_tpu_torch.index.ert as t_ert
import bwameme_tpu_torch.index.fmindex as t_fmindex
import bwameme_tpu_torch.index.formats as t_formats
import bwameme_tpu_torch.index.packing as t_packing
import bwameme_tpu_torch.index.suffix_array as t_sa
import bwameme_tpu_torch.io.fastq as t_fastq
import bwameme_tpu_torch.io.sam as t_sam
import bwameme_tpu_torch.models.prmi as t_prmi
import bwameme_tpu_torch.ops.build as t_ops_build
import bwameme_tpu_torch.seeding.fmi_engine as t_fmi_engine
import bwameme_tpu_torch.seeding.host_engine as t_host
import bwameme_tpu_torch.utils.config as t_config
import bwameme_tpu_torch.utils.fallbacks as t_fallbacks
import bwameme_tpu_torch.utils.timer as t_timer

PLANES = ("text", "sa", "isa", "key_hi", "key_lo", "text32", "rmi_leaf_start",
          "rmi_alpha", "rmi_beta", "rmi_err_lo", "rmi_err_hi")


def _code(seed=3, n=20000):
    rng = np.random.default_rng(seed)
    code = rng.integers(0, 4, n).astype(np.uint8)
    code[5000:5300] = np.tile(code[5000:5050], 6)
    return code


@pytest.fixture(scope="module")
def indexes():
    out = []
    for bntseq, build in ((j_bntseq, j_build), (t_bntseq, t_build)):
        code = _code()
        bns = bntseq.BntSeq(
            l_pac=len(code),
            contigs=[bntseq.Contig("c1", "", 0, 12000, 0),
                     bntseq.Contig("c2", "", 12000, len(code) - 12000, 0)],
            ambs=[], code=code)
        out.append(build.build_index(bns, rmi_bits=10))
    return out


@pytest.fixture(scope="module")
def reads(indexes):
    idx = indexes[0]
    rng = np.random.default_rng(4)
    out = []
    for i in range(12):
        st = int(rng.integers(0, idx.l_pac - 151))
        c = idx.text[st: st + 151].copy()
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, 151))
            c[p] = (c[p] + rng.integers(1, 4)) % 4
        if i % 2:
            c = (3 - c[::-1]).astype(np.uint8)
        out.append(c)
    out.append(idx.text[5000:5151].copy())
    return out


@pytest.mark.parametrize("plane", PLANES)
def test_build_index_planes(indexes, plane):
    a, b = (np.asarray(getattr(i, plane)) for i in indexes)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_build_index_scalars(indexes):
    a, b = indexes
    assert (a.n_sa, a.l_pac, a.rmi_bits, a.max_err) == (
        b.n_sa, b.l_pac, b.rmi_bits, b.max_err)


def test_save_and_load_index(indexes, tmp_path):
    a, b = indexes
    j_build.save_index(a, str(tmp_path / "j"))
    t_build.save_index(b, str(tmp_path / "t"))
    # each package loads what the other wrote
    la = t_build.load_index(str(tmp_path / "j"))
    lb = j_build.load_index(str(tmp_path / "t"))
    for plane in PLANES:
        assert np.asarray(getattr(la, plane)).tobytes() == np.asarray(
            getattr(lb, plane)).tobytes()
    assert [c.name for c in la.bns.contigs] == ["c1", "c2"]


def test_packing():
    code = _code(7, 1000)
    assert (j_packing.pack_words(code, pad_code=3)
            == t_packing.pack_words(code, pad_code=3)).all()
    assert (j_packing.NT4_TABLE == t_packing.NT4_TABLE).all()
    pos = np.arange(0, 1000, 7)         # the last keys run into the padding
    assert (j_packing.extract_key64(code, pos)
            == t_packing.extract_key64(code, pos)).all()


def test_suffix_array():
    code = _code(8, 3000)
    assert (j_sa.build_suffix_array(code) == t_sa.build_suffix_array(code)).all()


def test_prmi_training(indexes):
    """Retrain at other leaf bits on copies: same model, same windows."""
    a, b = (dataclasses.replace(i) for i in indexes)
    j_prmi.train_prmi(a, 8)
    t_prmi.train_prmi(b, 8)
    assert a.rmi_bits == b.rmi_bits == 8
    for plane in PLANES[6:]:
        assert np.asarray(getattr(a, plane)).tobytes() == np.asarray(
            getattr(b, plane)).tobytes()
    pa = j_prmi.predict_np(a, a.key_hi[::9], a.key_lo[::9])
    pb = t_prmi.predict_np(b, b.key_hi[::9], b.key_lo[::9])
    for x, y in zip(pa, pb):
        assert (np.asarray(x) == np.asarray(y)).all()


def test_sw_extend_and_align():
    rng = np.random.default_rng(5)
    mat = j_config.MemOptions().mat
    assert (mat == t_config.MemOptions().mat).all()
    for _ in range(20):
        q = rng.integers(0, 4, int(rng.integers(5, 60))).astype(np.uint8)
        t = np.concatenate([q[: len(q) // 2],
                            rng.integers(0, 4, 3).astype(np.uint8),
                            q[len(q) // 2:]])
        args = (q, t, mat, 6, 1, 6, 1, 30, 5, 100, 20)
        assert dataclasses.astuple(j_sw.sw_extend(*args)) == \
            dataclasses.astuple(t_sw.sw_extend(*args))


def test_native_library_and_sw(indexes):
    assert j_native.available() and t_native.available()
    rng = np.random.default_rng(6)
    mat = t_config.MemOptions().mat
    q = rng.integers(0, 4, 80).astype(np.uint8)
    t = np.concatenate([q[:40], q[43:], rng.integers(0, 4, 9).astype(np.uint8)])
    args = (q, t, mat, 6, 1, 6, 1, 40, 5, 100, 25)
    got = t_native.sw_extend_native(*args).tolist()
    assert got == j_native.sw_extend_native(*args).tolist()
    assert tuple(got) == dataclasses.astuple(t_sw.sw_extend(*args))


def test_host_seeding_engine(indexes, reads):
    a = j_host.HostSeedingEngine(indexes[0], j_config.MemOptions())
    b = t_host.HostSeedingEngine(indexes[1], t_config.MemOptions())
    for c in reads:
        assert ([dataclasses.astuple(s) for s in a.sorted_smems(c)]
                == [dataclasses.astuple(s) for s in b.sorted_smems(c)])


def test_ert_copy(indexes):
    """index/ert.py: the root table, its size, the reference .kmer_table
    entry codec, the k-mer ids and the classes a reference table holds."""
    key_hi = indexes[0].key_hi
    for bits in (2, 6, 9):
        a = j_ert.build_kmer_table(key_hi, bits)
        b = t_ert.build_kmer_table(key_hi, bits)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for n in (4, 1000, 40000, 6 * 10**9):
        assert j_ert.pick_ert_bits(n) == t_ert.pick_ert_bits(n)
    rng = np.random.default_rng(9)
    fields = (rng.integers(0, 4, 40), rng.integers(0, 1 << 14, 40),
              rng.integers(0, 20, 40), rng.integers(0, 4, 40),
              rng.integers(0, 1 << 30, 40))
    e = j_ert.encode_kmer_entries(*fields)
    assert np.array_equal(e, t_ert.encode_kmer_entries(*fields))
    for x, y in zip(j_ert.decode_kmer_entries(e),
                    t_ert.decode_kmer_entries(e)):
        assert np.array_equal(x, y)
    be = np.unique(key_hi >> np.uint32(2)).astype(np.int64)[:300]
    assert np.array_equal(j_ert.ref_kmer_id_from_be(be),
                          t_ert.ref_kmer_id_from_be(be))
    for x, y in zip(j_ert.kmer_classes_from_planes(key_hi, be),
                    t_ert.kmer_classes_from_planes(key_hi, be)):
        assert np.array_equal(x, y)
    assert t_ert.REF_NUM_KMERS == j_ert.REF_NUM_KMERS


def test_fmindex_copy(tmp_path):
    """index/fmindex.py: the planes, occ, the compressed-SA walk and the
    reference .bwt.2bit.64 file."""
    code = _code(seed=7, n=4000)
    a, b = j_fmindex.build_fm_index(code), t_fmindex.build_fm_index(code)
    for name in ("count", "bwt", "cp_count", "cp_bits", "sa", "sa_ms_byte",
                 "sa_ls_word"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert (a.n, a.sentinel_index) == (b.n, b.sentinel_index)
    p = np.arange(0, a.n + 2, 37)
    for base in range(4):
        assert np.array_equal(a.occ(base, p), b.occ(base, p))
    for r in range(0, a.n + 1, 97):
        assert a.get_sa_entry_compressed(r) == b.get_sa_entry_compressed(r)
    t_fmindex.write_bwt_2bit_64(b, str(tmp_path / "t"))
    c = j_fmindex.read_bwt_2bit_64(str(tmp_path / "t"))
    d = t_fmindex.read_bwt_2bit_64(str(tmp_path / "t"))
    assert np.array_equal(c.sa, d.sa) and np.array_equal(c.bwt, d.bwt)


def test_fmi_host_engine_copy(indexes, reads):
    """seeding/fmi_engine.FmiHostEngine: each read's SMEMs in emission
    order."""
    fm = t_fmindex.build_fm_index(indexes[1].bns.code)
    a = j_fmi_engine.FmiHostEngine(indexes[0], j_config.MemOptions(), fm=fm)
    b = t_fmi_engine.FmiHostEngine(indexes[1], t_config.MemOptions(), fm=fm)
    for c in reads[:6]:
        assert ([dataclasses.astuple(s) for s in a.collect_smems(c)]
                == [dataclasses.astuple(s) for s in b.collect_smems(c)])


def test_chains_from_chain_and_filter_raw(indexes, reads):
    ja, tb = indexes
    jo, to = j_config.MemOptions(), t_config.MemOptions()
    sj = [j_host.HostSeedingEngine(ja, jo).sorted_smems(c) for c in reads]
    st = [t_host.HostSeedingEngine(tb, to).sorted_smems(c) for c in reads]
    def used(raw):
        """The filled part of the flat chain arrays."""
        (chain_off, pos, rid, alt, w, kept, frep, seed_off, rbeg, qbeg, ln,
         n) = raw
        nc = int(chain_off[len(reads)])
        ns = int(seed_off[nc])
        return ([chain_off, seed_off[: nc + 1]]
                + [a[:nc] for a in (pos, rid, alt, w, kept, frep)]
                + [a[:ns] for a in (rbeg, qbeg, ln)] + [np.int64(n)])

    raw_j = used(j_chain.chain_and_filter_raw(jo, ja.bns, reads, sj, ja.sa))
    raw_t = used(t_chain.chain_and_filter_raw(to, tb.bns, reads, st, tb.sa))
    assert int(raw_t[-1]) > 0
    for x, y in zip(raw_j, raw_t):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    # the flat struct gives the same chains as the lists
    flat = t_host.FlatSmems(
        np.cumsum([0] + [len(s) for s in st]).astype(np.int32),
        *(np.array([getattr(s, k) for lst in st for s in lst], dt)
          for k, dt in (("start", np.int32), ("end", np.int32),
                        ("sa_lo", np.int64), ("hitcount", np.int64))))
    raw_f = used(t_chain.chain_and_filter_raw(to, tb.bns, reads, flat, tb.sa))
    for x, y in zip(raw_f, raw_t):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    assert j_chain.cal_max_gap(jo, 77) == t_chain.cal_max_gap(to, 77)


def test_sam_header_and_pg_line(indexes):
    ja, tb = indexes
    kw = dict(rg_line="@RG\tID:x\tSM:y", extra_hdr="@CO\thello",
              pg_line=j_sam.make_pg_line("1.0", "mem a b"))
    assert j_sam.make_pg_line("1.0", "mem a b") == t_sam.make_pg_line(
        "1.0", "mem a b")
    assert j_sam.sam_header(ja.bns, **kw) == t_sam.sam_header(tb.bns, **kw)


def test_fastq_reader(tmp_path):
    p = tmp_path / "r.fq"
    p.write_text("@a c1\nACGT\n+\nIIII\n@b\nNNAC\n+\nIIII\n@c\nAC\n+\nII\n")
    for keep in (False,):
        a = list(j_fastq.read_chunks(str(p), None, 6, keep_pairs=keep))
        b = list(t_fastq.read_chunks(str(p), None, 6, keep_pairs=keep))
        assert [[dataclasses.astuple(r) for r in ch] for ch in a] == [
            [dataclasses.astuple(r) for r in ch] for ch in b]
        assert sum(map(len, b)) == 3


def test_config_defaults():
    assert dataclasses.asdict(j_config.MemOptions()).keys() == \
        dataclasses.asdict(t_config.MemOptions()).keys()
    a, b = j_config.MemOptions(w=33, b=5), t_config.MemOptions(w=33, b=5)
    for k, v in dataclasses.asdict(a).items():
        assert np.all(np.asarray(v) == np.asarray(getattr(b, k))), k
    assert (j_config.fill_scmat(2, 7) == t_config.fill_scmat(2, 7)).all()


def test_timer_and_fallbacks():
    buf_j, buf_t = _io.StringIO(), _io.StringIO()
    for mod, buf in ((j_timer, buf_j), (t_timer, buf_t)):
        tm = mod.StageTimer()
        with tm.stage("a"):
            pass
        tm.report(buf)
        with mod.tstage("x.y"):
            pass
        assert "x.y" in mod.TPROF.totals
    assert buf_j.getvalue().split()[0] == buf_t.getvalue().split()[0]
    assert t_fallbacks.summary() == {} or isinstance(t_fallbacks.summary(),
                                                     dict)


def test_formats_module_is_the_ports_own():
    assert t_formats.__name__ == "bwameme_tpu_torch.index.formats"
    assert hasattr(t_formats, "import_reference_index")


def test_host_libraries_build_into_the_ports_own_directory():
    """The port loads the host libraries from its build directory, never
    from native/build/, which bwameme_tpu's own loaders write."""
    assert t_native.available() and t_sa._load_native() is not None
    for lib in (t_native._lib, t_sa._lib):
        assert os.path.dirname(lib._name) == t_ops_build.BUILD_DIR
        assert os.sep + os.path.join("native", "build") not in lib._name


RACE = r"""
import ctypes, sys
from bwameme_tpu_torch.align import native
from bwameme_tpu_torch.ops import build
lib = ctypes.CDLL(build.host_library("hostkernels", native.GXX_FLAGS,
                                     build_dir=sys.argv[1]))
print("loaded", bool(lib.invert_sa_c))
"""


def test_host_library_build_race(tmp_path):
    """Four processes build and load the host library into one empty
    directory at once: each compiles to a file of its own and renames it
    into place, so every one of them loads a whole library."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", RACE, str(tmp_path)],
                              cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "loaded True"
    assert sorted(os.listdir(tmp_path)) == ["libhostkernels.so"]


@pytest.fixture(scope="module")
def pe_regs(indexes):
    """Deduplicated regions of 12 FR pairs (the last one's mate mutated
    every 11th base, so that only a rescue places it), from the port's
    pipeline on the host engine, as each package's own AlnReg."""
    from bwameme_tpu_torch.io.fastq import Read
    from bwameme_tpu_torch.pipeline import Aligner

    idx = indexes[1]
    rng = np.random.default_rng(8)
    reads = []
    for i in range(12):
        p = int(rng.integers(0, idx.l_pac - 500))
        isize = int(rng.normal(300, 20))
        r1 = idx.text[p: p + 100].copy()
        r2 = (3 - idx.text[p + isize - 100: p + isize][::-1]).astype(np.uint8)
        if i == 11:
            r2[::11] = (r2[::11] + 1) % 4
        for name, c in (("a", r1), ("b", r2)):
            reads.append(Read(f"p{i}{name}", "".join("ACGT"[x] for x in c),
                              "I" * 100, None))
    opt = t_config.MemOptions()
    opt.flag |= t_config.MEM_F_PE
    al = Aligner(idx, opt, device="cpu")
    recs = [al._encode(r) for r in reads]
    regs = al._pe_kernels(recs)
    j_regs = [[j_extend.AlnReg(**{f.name: getattr(r, f.name)
                                  for f in dataclasses.fields(r)})
               for r in lst] for lst in regs]
    return idx, opt, recs, regs, j_regs


def test_finalize_copy(pe_regs):
    """mark_primary, approx_mapq and reg2sam on the same regions."""
    idx, opt, recs, regs, j_regs = pe_regs
    for k, (rec, a, b) in enumerate(zip(recs, regs, j_regs)):
        a = t_finalize.mark_primary(opt, copy.deepcopy(a), k)
        b = j_finalize.mark_primary(opt, copy.deepcopy(b), k)
        assert [dataclasses.astuple(x) for x in a] == [
            dataclasses.astuple(x) for x in b]
        assert [t_finalize.approx_mapq(opt, x) for x in a] == [
            j_finalize.approx_mapq(opt, x) for x in b]
        assert t_finalize.reg2sam(opt, idx.bns, idx.text, rec, rec.codes,
                                  a) == j_finalize.reg2sam(
            opt, idx.bns, idx.text, rec, rec.codes, b)


def test_alt_copy(pe_regs):
    """gen_alt's XA strings on regions with secondaries."""
    idx, opt, recs, regs, j_regs = pe_regs
    n_xa = 0
    for k, (rec, a, b) in enumerate(zip(recs, regs, j_regs)):
        a = t_finalize.mark_primary(opt, copy.deepcopy(a) * 2, k)
        b = j_finalize.mark_primary(opt, copy.deepcopy(b) * 2, k)
        xa = t_alt.gen_alt(opt, idx.bns, idx.text, a, len(rec.codes),
                           rec.codes)
        assert xa == j_alt.gen_alt(opt, idx.bns, idx.text, b,
                                   len(rec.codes), rec.codes)
        n_xa += sum(x is not None for x in xa)
    assert n_xa > 0


def test_pairing_copy(pe_regs):
    """pestat, then the serial sam_pe (mate rescue by the host SW, mem_pair,
    SAM) on every pair; the mutated mate is rescued."""
    idx, opt, recs, regs, j_regs = pe_regs
    pes_t = t_pairing.pestat(opt, idx.l_pac, regs)
    pes_j = j_pairing.pestat(opt, idx.l_pac, j_regs)
    assert [dataclasses.astuple(p) for p in pes_t] == [
        dataclasses.astuple(p) for p in pes_j]
    assert not regs[23]
    for i in range(0, len(recs), 2):
        got = t_pairing.sam_pe(opt, idx.bns, idx.text, pes_t, i >> 1,
                               recs[i: i + 2],
                               copy.deepcopy(regs[i: i + 2]))
        assert got == j_pairing.sam_pe(opt, idx.bns, idx.text, pes_j, i >> 1,
                                       recs[i: i + 2],
                                       copy.deepcopy(j_regs[i: i + 2]))
    assert not int(got[1].split("\t")[1]) & 4
