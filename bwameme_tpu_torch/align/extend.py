"""Chain -> alignment-region extension on the port's banded-SW kernel.

Port of bwameme_tpu/align/extend.py (mem_chain2aln, reference:
src/bwamem.cpp:2573-3489) with two paths that run the same kernel:

* the flat path (extend_flat_submit / extend_flat_finish): the alnreg table
  and coordinate jobs come from the native host library straight from the
  flat chain arrays; each round is one left and one right launch of
  ``banded_sw_coord`` against the packed text on the device, the right side
  reading its h0 from the scores the left launch wrote; band retries
  (MAX_BAND_TRY=2) rerun only the jobs whose retry predicate fires; the
  regions come back as a RegTable of arrays, which the single-end finalize
  reads as it is;
* the dataclass path (extend_chains_batch), for batches whose seeds need
  SW re-scoring (rescore_is_noop false): pairs of code arrays through
  ``banded_sw_pairs``; the regions come back as AlnReg lists.

The kernel takes its lengths at runtime, so none of the JAX package's
recompile ladders (lane, Q and T buckets, tile classes) is carried over;
jobs are sorted by target length before a launch instead.

The port owns ``AlnReg``: the reference module that defines it imports JAX.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from bwameme_tpu_torch.align import native
from bwameme_tpu_torch.align.chain import Chain, cal_max_gap, clamp_to_contig
from bwameme_tpu_torch.ops import banded_sw as bsw
from bwameme_tpu_torch.utils.timer import tstage

MAX_BAND_TRY = 2
H0_SENTINEL = -99  # reference: src/macro.h:44 H0_


@dataclasses.dataclass
class AlnReg:
    rb: int = H0_SENTINEL
    re: int = H0_SENTINEL
    qb: int = H0_SENTINEL
    qe: int = H0_SENTINEL
    rid: int = -1
    score: int = -1
    truesc: int = -1
    sub: int = 0
    csub: int = 0
    sub_n: int = 0
    alt_sc: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    hash: int = 0
    frac_rep: float = 0.0
    is_alt: bool = False
    seedlen0: int = 0
    n_comp: int = 1
    chain: Chain | None = None


def _seedcov(a: AlnReg) -> int:
    cov = 0
    for t in a.chain.seeds:
        if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                and t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
            cov += t.len
    return cov


@dataclasses.dataclass
class _Pair:
    query: np.ndarray
    ref: np.ndarray
    h0: int
    read_i: int
    reg_i: int


def _run_round(pairs: list[_Pair], opt, w: int, end_bonus: int, device):
    """One band-try round of the dataclass path: one kernel launch."""
    if not pairs:
        return []
    B = len(pairs)
    Q = max(1, max(len(p.query) for p in pairs))
    T = max(1, max(len(p.ref) for p in pairs))
    q = np.zeros((B, Q), np.int32)
    t = np.zeros((B, T), np.int32)
    lens = np.zeros((4, B), np.int32)  # qlen, tlen, h0, ws
    for b, p in enumerate(pairs):
        q[b, : len(p.query)] = p.query
        t[b, : len(p.ref)] = p.ref
        lens[:, b] = len(p.query), len(p.ref), p.h0, w
    qlen, tlen, h0, ws = torch.from_numpy(lens).to(device).unbind(0)
    out = bsw.banded_sw_extend_batch(
        torch.from_numpy(q).to(device), torch.from_numpy(t).to(device),
        qlen, tlen, h0, ws,
        torch.from_numpy(opt.mat.astype(np.int32)).to(device),
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, end_bonus, opt.zdrop)
    res = torch.stack([out[k] for k in bsw.SW_RESULT_ORDER])
    with tstage("extend.fetch"):
        res = res.cpu().numpy()
    return [dict(zip(bsw.SW_RESULT_ORDER, map(int, res[:, b])))
            for b in range(B)]


def extend_chains_batch(opt, bns, text: np.ndarray, queries: list[np.ndarray],
                        chains_per_read: list[list[Chain]],
                        device) -> list[list[AlnReg]]:
    """Extension for a batch of reads from dataclass chains. Returns
    alnregs per read (pre-dedup)."""
    l_pac = bns.l_pac
    regs_per_read: list[list[AlnReg]] = [[] for _ in queries]
    left_pairs: list[_Pair] = []
    right_pairs: list[_Pair] = []
    srt_per_chain: dict[tuple[int, int], list[int]] = {}

    for li, (query, chains) in enumerate(zip(queries, chains_per_read)):
        l_query = len(query)
        av = regs_per_read[li]
        for cj, c in enumerate(chains):
            if not c.seeds:
                continue
            # reference window (reference: src/bwamem.cpp:2649-2680)
            rmax0, rmax1 = l_pac << 1, 0
            for t in c.seeds:
                b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
                e = t.rbeg + t.len + (
                    (l_query - t.qbeg - t.len)
                    + cal_max_gap(opt, l_query - t.qbeg - t.len)
                )
                rmax0 = min(rmax0, b)
                rmax1 = max(rmax1, e)
            rmax0 = max(rmax0, 0)
            rmax1 = min(rmax1, l_pac << 1)
            if rmax0 < l_pac < rmax1:
                if c.seeds[0].rbeg < l_pac:
                    rmax1 = l_pac
                else:
                    rmax0 = l_pac
            rmax0, rmax1, rid = clamp_to_contig(bns, rmax0, c.seeds[0].rbeg,
                                                rmax1)
            if rid != c.rid:
                raise ValueError(f"chain window on contig {rid}, chain on "
                                 f"{c.rid}")
            rseq = text[rmax0:rmax1]

            # seeds in ascending (score, index); process descending
            srt = sorted(range(len(c.seeds)),
                         key=lambda i: (c.seeds[i].score, i))
            srt_per_chain[(li, cj)] = srt
            for k in range(len(c.seeds) - 1, -1, -1):
                s = c.seeds[srt[k]]
                a = AlnReg()
                av.append(a)
                s.aln = len(av) - 1
                a.w = opt.w
                a.rid = c.rid
                a.frac_rep = c.frac_rep
                a.seedlen0 = s.len
                a.chain = c
                if s.qbeg:  # left extension pair
                    qs = query[: s.qbeg][::-1]
                    rs = rseq[: s.rbeg - rmax0][::-1]
                    left_pairs.append(_Pair(qs, rs, s.len * opt.a, li, s.aln))
                    a.qb, a.rb = s.qbeg, s.rbeg
                else:
                    a.score = a.truesc = s.len * opt.a
                    a.qb, a.rb = 0, s.rbeg
                if s.qbeg + s.len != l_query:  # right extension pair
                    qe = s.qbeg + s.len
                    re = s.rbeg + s.len - rmax0
                    right_pairs.append(_Pair(query[qe:], rseq[re:], 0, li,
                                             s.aln))
                    a.qe, a.re = qe, rmax0 + re
                else:
                    a.qe, a.re = l_query, s.rbeg + s.len
                    if a.rb != H0_SENTINEL and a.qb != H0_SENTINEL:
                        a.seedcov = _seedcov(a)

    # ---- SW with band doubling (reference: src/bwamem.cpp:3040-3160) ----
    def run_side(pairs: list[_Pair], is_left: bool):
        end_bonus = opt.pen_clip5 if is_left else opt.pen_clip3
        pending = pairs
        for i in range(MAX_BAND_TRY):
            w = opt.w << i
            results = _run_round(pending, opt, w, end_bonus, device)
            nxt = []
            for p, r in zip(pending, results):
                a = regs_per_read[p.read_i][p.reg_i]
                prev = a.score
                a.score = r["score"]
                if (a.score == prev or r["max_off"] < (w >> 1) + (w >> 2)
                        or i + 1 == MAX_BAND_TRY):
                    if is_left:
                        if (r["gscore"] <= 0
                                or r["gscore"] <= a.score - opt.pen_clip5):
                            a.qb -= r["qle"]
                            a.rb -= r["tle"]
                            a.truesc = a.score
                        else:
                            a.qb = 0
                            a.rb -= r["gtle"]
                            a.truesc = r["gscore"]
                    else:
                        if (r["gscore"] <= 0
                                or r["gscore"] <= a.score - opt.pen_clip3):
                            a.qe += r["qle"]
                            a.re += r["tle"]
                            a.truesc += a.score - p.h0
                        else:
                            a.qe = len(queries[p.read_i])
                            a.re += r["gtle"]
                            a.truesc += r["gscore"] - p.h0
                    a.w = max(a.w, w)
                    if (a.rb != H0_SENTINEL and a.qb != H0_SENTINEL
                            and a.qe != H0_SENTINEL and a.re != H0_SENTINEL):
                        a.seedcov = _seedcov(a)
                else:
                    nxt.append(p)
            pending = nxt

    run_side(left_pairs, True)
    # right h0 = score after left extension (reference: src/bwamem.cpp:3168-3173)
    for p in right_pairs:
        p.h0 = regs_per_read[p.read_i][p.reg_i].score
    run_side(right_pairs, False)

    _purge_contained(opt, queries, chains_per_read, regs_per_read,
                     srt_per_chain)
    return regs_per_read


MEM_HSP_COEF_ = 1.1
MEM_MINSC_COEF_ = 5.5
MEM_SEEDSW_COEF_ = 0.05


def rescore_is_noop(opt, queries) -> bool:
    """True when mem_flt_chained_seeds (seed SW re-scoring) is a no-op for
    every read in the batch — the flat path's precondition (reference:
    src/bwamem.cpp:571-574: the pass is skipped when
    min_l > MEM_SEEDSW_COEF * l_query)."""
    for q in queries:
        lq = len(q)
        if lq <= 0:
            continue
        min_l = (MEM_HSP_COEF_ * opt.min_chain_weight
                 if opt.min_chain_weight
                 else MEM_MINSC_COEF_ * math.log(lq))
        if min_l <= MEM_SEEDSW_COEF_ * lq:
            return False
    return True


# ---------------------------------------------------------------- flat path


def _side_jobs(prep, side: str, idx: np.ndarray, ws) -> np.ndarray:
    """(7, n) int32 jobs reg, row, qstart, qlen, tstart, tlen, ws."""
    jobs = np.zeros((7, len(idx)), np.int32)
    jobs[0] = prep[f"{side}_reg"][idx]
    jobs[1] = prep[f"{side}_row"][idx]
    if side == "r":  # a left query is read[:qlen] reversed: qstart 0
        jobs[2] = prep["r_qstart"][idx]
    jobs[3] = prep[f"{side}_qlen"][idx]
    jobs[4] = prep[f"{side}_tstart"][idx]
    jobs[5] = prep[f"{side}_tlen"][idx]
    jobs[6] = ws
    return jobs


def _launch_round(opt, prep, aux, score_reg, l_idx, l_ws, r_idx, r_ws):
    """One extension round: the left launch writes its scores into
    score_reg, the right launch (after it on the same stream) reads its h0
    from there. Returns the (8, n) result tensors of both sides, in job
    order, without waiting for the device."""
    dev = aux["text32"].device
    sides = []
    for side, idx, ws in (("l", l_idx, l_ws), ("r", r_idx, r_ws)):
        jobs = _side_jobs(prep, side, idx, ws)
        # longest targets first: a job is a warp of its own and a launch
        # lasts as long as its longest job, so the long ones start first
        order = np.argsort(-jobs[5], kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        jobs = np.ascontiguousarray(jobs[:, order])
        sides.append((torch.from_numpy(jobs).to(dev),
                      torch.from_numpy(inv).to(dev)))
    # every upload above precedes the first launch: a copy from pageable
    # host memory waits for the stream, so uploading between the two
    # launches would stall the host on the left launch
    out = []
    for (jobs, inv), reverse, end_bonus in zip(
            sides, (True, False), (opt.pen_clip5, opt.pen_clip3)):
        if jobs.shape[1] == 0:
            out.append(torch.zeros((8, 0), dtype=torch.int32, device=dev))
            continue
        res = bsw.extend_side_round(
            aux["text32"], aux["codes"], aux["mat"], score_reg, jobs,
            opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, end_bonus, opt.zdrop,
            reverse=reverse, write_scores=reverse)  # the left side writes
        out.append(res.index_select(1, inv))
    return out


def extend_flat_submit(opt, bns, queries, chain_raw, text):
    """Build the alnreg table and jobs natively from the flat chain arrays
    and launch round 1 on ``text``'s device (a DeviceText). Returns a token
    for extend_flat_finish; the device work is not awaited."""
    if not native.available():
        raise RuntimeError("the flat extension path needs the native host "
                           "library (native/hostkernels.cpp, built with g++)")
    (chain_off, _pos, chain_rid, _alt, _w, _kept, chain_frac_rep,
     seed_off, seed_rbeg, seed_qbeg, seed_len, _n) = chain_raw
    R = len(queries)
    lq = np.asarray([len(q) for q in queries], np.int32)
    ctg_off = np.ascontiguousarray([c.offset for c in bns.contigs],
                                   dtype=np.int64)
    prep = native.extend_prepare_native(
        opt, bns, lq, chain_off, chain_rid, chain_frac_rep, seed_off,
        seed_rbeg, seed_qbeg, seed_len, ctg_off)
    G = prep["n_regs"]
    left = right = aux = None
    if G:
        dev = text.device
        codes = np.zeros((R, max(len(q) for q in queries)), np.uint8)
        for i, q in enumerate(queries):
            codes[i, : len(q)] = np.minimum(q, 4)
        aux = dict(text32=text.text32,
                   codes=torch.from_numpy(codes).to(dev),
                   mat=torch.from_numpy(opt.mat.astype(np.int32)).to(dev))
        score_reg = torch.from_numpy(prep["reg_h0seed"][:G].copy()).to(dev)
        nl, nr = prep["n_left"], prep["n_right"]
        left, right = _launch_round(
            opt, prep, aux, score_reg, np.arange(nl),
            np.full(nl, opt.w, np.int32), np.arange(nr),
            np.full(nr, opt.w, np.int32))
    return (opt, queries, lq, chain_raw, prep, left, right, aux)


def _fetch(left, right, nl: int, nr: int):
    """One device->host copy of both sides' results, as dicts of rows."""
    with tstage("extend.fetch"):
        cat = torch.cat([left, right], 1).cpu().numpy()
    return ({k: cat[i, :nl].copy() for i, k in enumerate(bsw.EXT_ROUND_ORDER)},
            {k: cat[i, nl:].copy() for i, k in enumerate(bsw.EXT_ROUND_ORDER)})


def _dispatch_retry_round(opt, prep, aux, h0_reg, l_idx, l_ws, r_idx, r_ws):
    """A follow-up round for the given job subsets; returns per-subset
    result dicts."""
    score_reg = torch.from_numpy(h0_reg).to(aux["text32"].device)
    la, ra = _launch_round(opt, prep, aux, score_reg, l_idx, l_ws, r_idx,
                           r_ws)
    return _fetch(la, ra, len(l_idx), len(r_idx))


@dataclasses.dataclass
class RegTable:
    """A batch's regions as the flat path's C++ fold left them, one row a
    region: read r's rows are ``off[r]:off[r+1]``, in the order extension
    made them, purged regions (qb == qe == -1) included. The columns are
    views of the extension's own arrays, in the dtypes finalize_se_c takes
    (rb, re int64; frac_rep float64; is_alt uint8; the rest int32). It has
    no sub or csub: both are 0 here, AlnReg's defaults."""

    COLUMNS = ("rb", "re", "qb", "qe", "rid", "score", "truesc", "w",
               "seedcov", "seedlen0", "frac_rep")

    off: np.ndarray
    rb: np.ndarray
    re: np.ndarray
    qb: np.ndarray
    qe: np.ndarray
    rid: np.ndarray
    score: np.ndarray
    truesc: np.ndarray
    w: np.ndarray
    seedcov: np.ndarray
    seedlen0: np.ndarray
    frac_rep: np.ndarray
    is_alt: np.ndarray

    def to_lists(self) -> list[list[AlnReg]]:
        """One AlnReg a region, per read: what pairing and the paired-end
        dedup read. Timed as ``extend.objects``."""
        with tstage("extend.objects"):
            cols = [getattr(self, k).tolist() for k in self.COLUMNS]
            flat = [AlnReg(rb=rb, re=re, qb=qb, qe=qe, rid=rid, score=sc,
                           truesc=tsc, w=w, seedcov=cov, seedlen0=sl0,
                           frac_rep=frep, is_alt=ia, chain=None)
                    for (rb, re, qb, qe, rid, sc, tsc, w, cov, sl0, frep), ia
                    in zip(zip(*cols), (self.is_alt != 0).tolist())]
            off = self.off.tolist()
            return [flat[a:b] for a, b in zip(off, off[1:])]


def extend_flat_finish(token) -> RegTable:
    """Wait for round 1, run the band-retry ladder (reference:
    src/bwamem.cpp:2968-3022, MAX_BAND_TRY=2: rerun a side at the doubled
    band iff the score changed and max_off crossed the band threshold; a
    rerun left also reruns its dependent right with the new h0), then the
    native fold + seedcov + purge. Returns the regions as a RegTable: no
    Python object a region (RegTable.to_lists builds the AlnRegs)."""
    (opt, queries, lq, chain_raw, prep, left, right, aux) = token
    (chain_off, _pos, _rid, chain_is_alt, _w, _kept, _frep,
     seed_off, seed_rbeg, seed_qbeg, seed_len, _n) = chain_raw
    R = len(queries)
    G = prep["n_regs"]
    read_reg_off = np.searchsorted(
        prep["reg_read"][:G], np.arange(R + 1)).astype(np.int32)
    if G:
        nl, nr = prep["n_left"], prep["n_right"]
        L, Rt = _fetch(left, right, nl, nr)
        w0 = opt.w
        thr = (w0 >> 1) + (w0 >> 2)
        # round-1 retry predicate (left prev is -1, so only max_off gates)
        l_retry = L["max_off"] >= thr
        r_retry = (Rt["score"] != Rt["h0"]) & (Rt["max_off"] >= thr)
        if l_retry.any() or r_retry.any():
            l_idx = np.flatnonzero(l_retry)
            lr_regs = prep["l_reg"][:nl][l_idx]
            # rights whose reg's left is being rerun get a fresh h0 run at
            # w; independently-retried rights rerun at 2w directly
            rd_mask = np.isin(prep["r_reg"][:nr], lr_regs)
            r_idx = np.flatnonzero(rd_mask | r_retry)
            r_ws2 = np.where(rd_mask[r_idx], w0, 2 * w0).astype(np.int32)
            h0p = prep["reg_h0seed"][:G].copy()
            keep = np.flatnonzero(~l_retry)
            h0p[prep["l_reg"][:nl][keep]] = L["score"][keep]
            L2, R2 = _dispatch_retry_round(
                opt, prep, aux, h0p, l_idx,
                np.full(len(l_idx), 2 * w0, np.int32), r_idx, r_ws2)
            for k in bsw.EXT_ROUND_ORDER:
                L[k][l_idx] = L2[k]
                Rt[k][r_idx] = R2[k]
            # a dependent right that ran at w may itself retry once more
            again = np.zeros(nr, bool)
            again[r_idx] = ((R2["score"] != R2["h0"])
                            & (R2["max_off"] >= thr)
                            & (R2["w_used"] == w0))
            a_idx = np.flatnonzero(again)
            if len(a_idx):
                h0f = h0p.copy()
                h0f[lr_regs] = L["score"][l_idx]
                _, R3 = _dispatch_retry_round(
                    opt, prep, aux, h0f, np.zeros(0, np.intp),
                    np.zeros(0, np.int32), a_idx,
                    np.full(len(a_idx), 2 * w0, np.int32))
                for k in bsw.EXT_ROUND_ORDER:
                    Rt[k][a_idx] = R3[k]
        native.extend_finalize_native(
            opt, lq, read_reg_off, prep, chain_off, seed_off, seed_rbeg,
            seed_qbeg, seed_len, L, Rt)
    is_alt = np.asarray(chain_is_alt)[prep["reg_chain"][:G]] != 0
    return RegTable(
        off=read_reg_off,
        **{k: prep[f"reg_{k}"][:G] for k in RegTable.COLUMNS},
        is_alt=is_alt.astype(np.uint8))


def _purge_contained(opt, queries, chains_per_read, regs_per_read,
                     srt_per_chain):
    """Contained-seed purge (reference: src/bwamem.cpp:3390-3489)."""
    for li, (query, chains) in enumerate(zip(queries, chains_per_read)):
        l_query = len(query)
        av = regs_per_read[li]
        lim = 0
        for cj, c in enumerate(chains):
            if not c.seeds:
                continue
            srt = srt_per_chain[(li, cj)]
            purged = [False] * len(c.seeds)
            for k in range(len(c.seeds) - 1, -1, -1):
                s = c.seeds[srt[k]]
                v = 0
                found = False
                for p in av:
                    if v >= lim:
                        break
                    if p.qb == -1 and p.qe == -1:
                        continue
                    if (s.rbeg < p.rb or s.rbeg + s.len > p.re
                            or s.qbeg < p.qb or s.qbeg + s.len > p.qe):
                        v += 1
                        continue
                    if s.len - p.seedlen0 > 0.1 * l_query:
                        v += 1
                        continue
                    qd = s.qbeg - p.qb
                    rd = s.rbeg - p.rb
                    max_gap = cal_max_gap(opt, min(qd, rd))
                    ww = min(max_gap, p.w)
                    if qd - rd < ww and rd - qd < ww:
                        found = True
                        break
                    qd = p.qe - (s.qbeg + s.len)
                    rd = p.re - (s.rbeg + s.len)
                    max_gap = cal_max_gap(opt, min(qd, rd))
                    ww = min(max_gap, p.w)
                    if qd - rd < ww and rd - qd < ww:
                        found = True
                        break
                    v += 1
                if found:
                    ok = True
                    for v2 in range(k + 1, len(c.seeds)):
                        if purged[v2]:
                            continue
                        t = c.seeds[srt[v2]]
                        if t.len < s.len * 0.95:
                            continue
                        if (s.qbeg <= t.qbeg
                                and s.qbeg + s.len - t.qbeg >= s.len >> 2
                                and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                            ok = False
                            break
                        if (t.qbeg <= s.qbeg
                                and t.qbeg + t.len - s.qbeg >= s.len >> 2
                                and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                            ok = False
                            break
                    if ok:
                        ar = av[s.aln]
                        ar.qb = ar.qe = -1
                        purged[k] = True
                        continue
                lim += 1
    return regs_per_read
