"""Banded global alignment with traceback (bwa's ksw_global2, the DP of
bwa_gen_cigar2) for a batch of CIGAR jobs: dispatch and plain version.

The single-end finalize (align/finalize_split.py) lists every region whose
CIGAR goes into the SAM as a job, (5, N) int64 rows rb, qstart, qlen, rlen,
w: the query is codes[qstart : qstart + qlen], the target text[rb : rb +
rlen], both reversed when rb >= l_pac, and w is reg2aln's first band.
gen_cigar turns w into the DP's band (its clamps: ``band_width``) or, for a
query as long as its target and w == 0, takes no DP at all. Each job gives
a row of (N, 2 + slots) int32: the score, the count of CIGAR runs and the
runs, packed len<<4|op (0 M, 1 I, 2 D) in SAM order. Where the count is
below 0 the job is the host's (the C++ plan recomputes it with gen_cigar):
OVER_BUDGET, its DP state passes a warp's shared memory (BUDGET_WORDS) or it
has no DP to run; OVER_SLOTS, its CIGAR has more runs than ``slots``;
OFF_BAND, its traceback left the band. Which jobs are over budget depends
on their shapes alone.

CUDA tensors go to the hand-written kernel (ops/sw_global_cuda.py,
csrc/sw_global.cu), CPU tensors to the plain PyTorch version below, and any
other device raises. There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bwameme_tpu_torch.ops import sw_global_cuda

NEG_INF = -0x40000000   # sw_global_c's
NO_CELL = -(3 << 29)    # below every value of the F scan
OVER_BUDGET, OVER_SLOTS, OFF_BAND = -1, -2, -3
SLOTS = 32              # CIGAR runs a job's output row holds
BUDGET_WORDS = 2048     # shared memory words of a warp (8 KiB): a 151 bp
                        # job fits bands up to 43 (gen_cigar's reaches 36
                        # where query and target are as long)


@dataclasses.dataclass
class CigarStats:
    """Jobs listed by the single-end finalize's plans, and of them those the
    host ran (flagged, or on the band ladder): the mechanism's counters,
    beside the kernel's launches in ops/launch.py."""
    jobs: int = 0
    host: int = 0

    def reset(self) -> None:
        self.jobs = self.host = 0


stats = CigarStats()


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"global alignment runs on CUDA or the CPU, not "
                         f"{x.device}")
    return False


def band_width(qlen, rlen, w, a: int, o_del: int, e_del: int, o_ins: int,
               e_ins: int):
    """gen_cigar's band of jobs (int64 tensors) whose first band is w: half
    the query's best score pays for the longest gap, in double as the host
    divides."""
    half = ((qlen + 1) >> 1) * a
    max_ins = ((half - o_ins).double() / e_ins + 1.0).long()
    max_del = ((half - o_del).double() / e_del + 1.0).long()
    max_gap = torch.maximum(max_ins, max_del).clamp(min=1)
    diff = (rlen - qlen).abs()
    ww = torch.minimum((max_gap + diff + 1) >> 1, w)
    return torch.maximum(ww, diff + 3)


def state_words(qlen, rlen, ww, slots: int):
    """A job's words in its warp's slice: Hs and Es, the query's codes as
    bytes, a direction nibble a cell of every row, the runs' scratch."""
    n_col = torch.minimum(qlen, 2 * ww + 1)
    return 2 * (qlen + 1) + (qlen + 3) // 4 + ((n_col + 7) >> 3) * rlen + slots


def decode_target(text32, rb, rlen, rev, T: int):
    """(N, T) int64 codes of text[rb : rb + rlen], reversed where rev;
    positions past rlen are 0."""
    i = torch.arange(T, device=rb.device)
    rel = torch.where(rev[:, None], rlen[:, None] - 1 - i, i)
    p = rb[:, None] + rel.clamp(min=0)
    words = text32[(p >> 4).clamp(0, text32.numel() - 1)].long() & 0xFFFFFFFF
    code = (words >> ((15 - (p & 15)) * 2)) & 3
    return torch.where(i < rlen[:, None], code, 0)


def gather_query(codes, qstart, qlen, rev, Q: int):
    """(N, Q) int64 codes of codes[qstart : qstart + qlen] clamped to 0..4,
    reversed where rev; positions past qlen are 0."""
    j = torch.arange(Q, device=qstart.device)
    rel = torch.where(rev[:, None], qlen[:, None] - 1 - j, j)
    idx = (qstart[:, None] + rel).clamp(0, max(codes.numel() - 1, 0))
    q = codes[idx].long().clamp(max=4) if codes.numel() else \
        torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    return torch.where(j < qlen[:, None], q, 0)


def _dp(q, t, qlen, tlen, ww, mat, o_del, e_del, o_ins, e_ins):
    """The scalar code's DP, a row of every job at a time over every column:
    returns each job's score and its direction nibbles (N, T, Q) by absolute
    column (0 outside the band)."""
    dev = q.device
    N, Q = q.shape
    T = t.shape[1]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    jj = torch.arange(Q + 1, device=dev)
    Hs = torch.where(jj == 0, 0, torch.where(
        jj[None, :] <= ww[:, None], -(o_ins + e_ins * jj), NEG_INF))
    Hs = Hs.expand(N, Q + 1).clone()
    Es = torch.full((N, Q + 1), NEG_INF, dtype=torch.int64, device=dev)
    z = torch.zeros((N, T, Q), dtype=torch.uint8, device=dev)
    j = jj[:Q]
    rows = torch.arange(N, device=dev)
    for i in range(T):
        live = i < tlen
        beg = (i - ww).clamp(min=0)
        end = torch.minimum(i + ww + 1, qlen)
        inb = live[:, None] & (j >= beg[:, None]) & (j < end[:, None])
        m = Hs[:, :Q] + mat[t[:, i]].gather(1, q)
        e = Es[:, :Q]
        d = (m < e).long()
        h = torch.maximum(m, e)
        tdel = m - oe_del
        ext_e = e - e_del > tdel
        en = torch.where(ext_e, e - e_del, tdel)
        tins = m - oe_ins
        u = torch.where(inb, tins + j * e_ins, NO_CELL)
        before = torch.cat([torch.full((N, 1), NO_CELL, dtype=torch.int64,
                                       device=dev),
                            torch.cummax(u, 1).values[:, :-1]], 1)
        f = torch.maximum(before, (NEG_INF + (beg - 1) * e_ins)[:, None]) \
            - (j - 1) * e_ins
        use_f = h < f
        d = torch.where(use_f, 2, d)
        h = torch.where(use_f, f, h)
        d = d | torch.where(ext_e, 4, 0) | torch.where(f - e_ins > tins, 8, 0)
        h1 = torch.where(beg == 0, -(o_del + e_del * (i + 1)), NEG_INF)
        hp = torch.cat([h1[:, None], h[:, :-1]], 1)
        hp = torch.where(j == beg[:, None], h1[:, None], hp)
        Hs[:, :Q] = torch.where(inb, hp, Hs[:, :Q])
        Es[:, :Q] = torch.where(inb, en, Es[:, :Q])
        # cell `end` takes H(i, end-1) and E = NEG_INF
        last = torch.where(
            end > beg, h.gather(1, (end - 1).clamp(0, Q - 1)[:, None])[:, 0],
            h1)
        Hs[rows[live], end[live]] = last[live]
        Es[rows[live], end[live]] = NEG_INF
        z[:, i, :] = torch.where(inb, d, 0).to(torch.uint8)
    return Hs.gather(1, qlen[:, None])[:, 0], z


def _traceback(z, qlen, tlen, ww, slots: int):
    """The scalar code's traceback of every job at once: (count or flag,
    runs (N, slots) in SAM order)."""
    dev = z.device
    N = z.shape[0]
    n_col = torch.minimum(qlen, 2 * ww + 1)
    rows = torch.arange(N, device=dev)
    i = tlen - 1
    k = torch.minimum(i + ww + 1, qlen) - 1
    which = torch.zeros(N, dtype=torch.int64, device=dev)
    flag = torch.zeros(N, dtype=torch.int64, device=dev)
    op = torch.full((N,), -1, dtype=torch.int64, device=dev)
    ln = torch.zeros(N, dtype=torch.int64, device=dev)
    n = torch.zeros(N, dtype=torch.int64, device=dev)
    runs = torch.zeros((N, slots), dtype=torch.int64, device=dev)

    def push(sel, o2, l2):
        """push(o2, l2) of the jobs in sel: a new op ends the current run,
        which goes to the runs (last run first) if a slot is left."""
        same = sel & (op == o2)
        new = sel & ~same
        full = new & (op >= 0) & (n >= slots)
        flag.masked_fill_(full, OVER_SLOTS)
        store = new & (op >= 0) & ~full
        runs[rows[store], n[store]] = ln[store] << 4 | op[store]
        n.add_(store.long())
        ln.copy_(torch.where(same, ln + l2, torch.where(new, l2, ln)))
        op.copy_(torch.where(new, o2, op))

    while True:
        alive = (i >= 0) & (k >= 0) & (flag == 0)
        if not bool(alive.any()):
            break
        c = k - (i - ww).clamp(min=0)
        off = alive & ((c < 0) | (c >= n_col))
        flag.masked_fill_(off, OFF_BAND)
        alive &= ~off
        nib = z[rows, i.clamp(min=0), k.clamp(min=0)].long()
        which = torch.where(alive, torch.where(
            which == 0, nib & 3, torch.where(
                which == 1, (nib >> 2) & 1, ((nib >> 3) & 1) * 2)), which)
        step = torch.where(which == 0, 0, torch.where(which == 1, 2, 1))
        push(alive, step, 1)
        alive &= flag == 0
        i = torch.where(alive & (step != 1), i - 1, i)
        k = torch.where(alive & (step != 2), k - 1, k)
    push((flag == 0) & (i >= 0), 2, i + 1)
    push((flag == 0) & (k >= 0), 1, k + 1)
    push((flag == 0) & (op >= 0), -2, 0)   # flushes the last run
    t = torch.arange(slots, device=dev)
    src = (n[:, None] - 1 - t).clamp(min=0)
    runs = torch.where(t < n[:, None], runs.gather(1, src), 0)
    return torch.where(flag != 0, flag, n), runs


def sw_global_coord_torch(text32, codes, jobs, mat, l_pac: int, o_del: int,
                          e_del: int, o_ins: int, e_ins: int, slots: int,
                          budget_words: int):
    """Plain version of the kernel on any device, all values equal."""
    dev = jobs.device
    N = jobs.shape[1]
    out = torch.zeros((N, 2 + slots), dtype=torch.int32, device=dev)
    if N == 0:
        return out
    rb, qstart, qlen, rlen, w = jobs.long().unbind(0)
    mat = mat.long()
    rev = rb >= l_pac
    bad = (qlen <= 0) | (rlen <= 0)
    nodp = ~bad & (qlen == rlen) & (w == 0)
    ww = band_width(qlen, rlen, w, int(mat[0, 0]), o_del, e_del, o_ins, e_ins)
    over = bad | (~nodp & (state_words(qlen, rlen, ww, slots)
                           > budget_words))
    out[:, 1] = torch.where(over, OVER_BUDGET, 0).to(torch.int32)
    for sel, dp in ((nodp & ~bad, False), (~over & ~nodp, True)):
        idx = torch.nonzero(sel)[:, 0]
        if idx.numel() == 0:
            continue
        ql, tl = qlen[idx], rlen[idx]
        Q, T = int(ql.max()), int(tl.max())
        q = gather_query(codes, qstart[idx], ql, rev[idx], Q)
        t = decode_target(text32, rb[idx], tl, rev[idx], T)
        if not dp:
            sc = torch.where(torch.arange(Q, device=dev) < ql[:, None],
                             mat[t[:, :Q], q], 0).sum(1)
            out[idx, 0] = sc.to(torch.int32)
            out[idx, 1] = 1 if slots else OVER_SLOTS
            if slots:
                out[idx, 2] = (ql << 4).to(torch.int32)
            continue
        score, z = _dp(q, t, ql, tl, ww[idx], mat, o_del, e_del, o_ins,
                       e_ins)
        n, runs = _traceback(z, ql, tl, ww[idx], slots)
        out[idx, 0] = score.to(torch.int32)
        out[idx, 1] = n.to(torch.int32)
        out[idx, 2:] = torch.where(n[:, None] > 0, runs, 0).to(torch.int32)
    return out


def sw_global_coord(text32, codes, jobs, mat, l_pac: int, o_del: int,
                    e_del: int, o_ins: int, e_ins: int, slots: int = SLOTS,
                    budget_words: int = BUDGET_WORDS):
    """text32 the int32 view of the packed text words (both strands), codes
    (n,) uint8 read codes, jobs (5, N) int64, mat (5, 5) int32. Returns (N,
    2 + slots) int32 (module docstring)."""
    fn = (sw_global_cuda.sw_global_coord if _on_cuda(jobs)
          else sw_global_coord_torch)
    return fn(text32, codes, jobs, mat, l_pac, o_del, e_del, o_ins, e_ins,
              slots, budget_words)


def cigars(text32, codes: np.ndarray, jobs: np.ndarray, opt,
           l_pac: int) -> np.ndarray:
    """The jobs' results for the single-end finalize, as a host array: on
    CUDA the kernel's (align_jobs). On the CPU every job is flagged
    OVER_BUDGET, and the host's gen_cigar runs each one, as finalize_se_c
    does: the plain version's DP would take longer there than the C++."""
    if _on_cuda(text32):
        return align_jobs(text32, codes, jobs, opt, l_pac)
    out = np.zeros((jobs.shape[1], 2 + SLOTS), np.int32)
    out[:, 1] = OVER_BUDGET
    return out


def align_jobs(text32, codes: np.ndarray, jobs: np.ndarray, opt,
               l_pac: int) -> np.ndarray:
    """The jobs' results on text32's device (the kernel on CUDA, the plain
    version on the CPU), as a host array: one upload of the job table, the
    scoring matrix and the codes, one launch, one readback; SLOTS runs a
    job, BUDGET_WORDS a warp."""
    slots, budget_words = SLOTS, BUDGET_WORDS
    N = jobs.shape[1]
    if N == 0:
        return np.zeros((0, 2 + slots), np.int32)
    buf = np.empty(40 * N + 100 + len(codes), np.uint8)
    buf[: 40 * N] = np.ascontiguousarray(jobs, np.int64).reshape(-1).view(
        np.uint8)
    buf[40 * N: 40 * N + 100] = np.ascontiguousarray(
        opt.mat, np.int32).reshape(-1).view(np.uint8)
    buf[40 * N + 100:] = codes
    dev = text32.device
    up = torch.from_numpy(buf).to(dev)
    out = sw_global_coord(
        text32, up[40 * N + 100:], up[: 40 * N].view(torch.int64).view(5, N),
        up[40 * N: 40 * N + 100].view(torch.int32).view(5, 5), l_pac,
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, slots, budget_words)
    return out.cpu().numpy()
