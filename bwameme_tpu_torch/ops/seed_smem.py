"""The three SMEM seeding rounds, read prep and pack: dispatch and plain
versions.

Port of the device programs of bwameme_tpu/seeding/engine.py. Each round
takes tensors on one device: CUDA tensors go to the hand-written kernel
(ops/seed_smem_cuda.py, csrc/seed_smem.cu), CPU tensors to the plain PyTorch
version below, any other device raises. There is no fallback from a kernel
to its plain version.

The plain versions advance every read of the batch by one state-machine
transition per step over the batched primitives of ops/sa_search.py, as the
reference's lane-masked loops do, and stop when no read is active. They are
the CPU path and what the kernels are held against on the card. Read prep
and pack are elementwise/scan glue (XLA in the reference) and stay torch ops
on every device.

A round returns ``(slots, nsm, dropped)``: slots (4, R, M) planes start,
end, sa_lo, hitcount in emission order, int32 or, over a wide index, int64
(as the JAX engine's wide slot planes; read coordinates fit either), nsm
(R,) int32 the slots used, and dropped (R,) int32 the emissions that did not
fit in M slots. Those are lost, as
the reference loses them; the engine counts them and says so on stderr.

The plain rounds and ``sa_query_torch`` take an optional ``work``, an
``ops.sa_search.Work`` with one lane a read (a job), and count into it what
the data needs of the index, whatever the design of the kernel that does
it: the probes of the scalar contract's binary searches a read, and the
distinct sectors the answers stand on. The kernels' byte bounds are reckoned
from the second, the least a launch can move.
"""

from __future__ import annotations

import torch

from bwameme_tpu_torch.index.device import DeviceIndex
from bwameme_tpu_torch.ops import sa_search as ss
from bwameme_tpu_torch.ops import seed_smem_cuda

I64 = torch.int64
DONE, RIGHT0, LEFT, RIGHT_Z = 0, 1, 2, 3
NEVER = 1 << 40                 # longer than any match


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"seeding runs on CUDA or the CPU, not {x.device}")
    return False


# ------------------------------------------------------------------- prep


def prepare_reads(mat: torch.Tensor, lens: torch.Tensor):
    """Batch preparation (bwameme_tpu/seeding/engine.py:312-363) from the
    (R, L) uint8 code matrix and the read lengths: the packed query buffer
    (2R, W) - forward rows, then reverse-complement rows, 16 bases a uint32
    word, most significant bits first, N packed as 0, rows padded with T and
    three all-ones guard words - held as int32 storage, and the (R, L + 1)
    int32 tables next N (forward, reverse complement) and next non-N, each
    clipped to the read length."""
    R, L = mat.shape
    dev = mat.device
    lensc = lens.to(I64)[:, None]
    cols = torch.arange(L, device=dev)[None, :]
    valid = cols < lensc
    m = torch.where(valid, mat.to(I64), 3)
    rj = torch.gather(m, 1, (lensc - 1 - cols).clamp(0, L - 1))
    rc = torch.where((rj < 4) & valid, 3 - rj, torch.where(valid, rj, 3))
    both = torch.cat([m, rc])
    safe = torch.where(both >= 4, 0, both)
    pad = (-L) % 16
    if pad:
        safe = torch.cat(
            [safe, torch.full((2 * R, pad), 3, dtype=I64, device=dev)], 1)
    sh = (15 - torch.arange(16, device=dev)) * 2
    words = (safe.reshape(2 * R, -1, 16) << sh).sum(2)
    qbuf = torch.full((2 * R, (L + 15) // 16 + 3), ss.FULL, dtype=I64,
                      device=dev)
    qbuf[:, : words.shape[1]] = words
    big = 1 << 30

    def suffix_min(marker):
        x = torch.where(marker, cols, big)
        sm = torch.flip(torch.cummin(torch.flip(x, [1]), 1).values, [1])
        sm = torch.cat([sm, torch.full((R, 1), big, dtype=I64, device=dev)], 1)
        return torch.minimum(sm, lensc).to(torch.int32)

    # int64 -> int32 keeps the low 32 bits: the uint32 words as int32 storage
    return (qbuf.to(torch.int32), suffix_min(valid & (m >= 4)),
            suffix_min(valid & (rc >= 4)), suffix_min(valid & (m < 4)))


# --------------------------------------------------- plain rounds (any device)


class _Emitter:
    """Emission slots of one round, written lane by lane in emission order."""

    def __init__(self, R: int, M: int, dev, dtype) -> None:
        self.M = M
        self.slots = torch.zeros((4, R, M), dtype=dtype, device=dev)
        self.nsm = torch.zeros(R, dtype=I64, device=dev)
        self.dropped = torch.zeros(R, dtype=I64, device=dev)

    def emit(self, mask, start, end, lb, cnt) -> None:
        fit = mask & (self.nsm < self.M)
        lanes = torch.nonzero(fit)[:, 0]
        if lanes.numel():
            vals = torch.stack([start, end, lb, cnt])[:, lanes]
            self.slots[:, lanes, self.nsm[lanes]] = vals.to(self.slots.dtype)
        self.nsm += fit
        self.dropped += mask & ~fit

    def result(self):
        return (self.slots, self.nsm.to(torch.int32),
                self.dropped.to(torch.int32))


def _tab(t, lanes, pos):
    return t[lanes, pos.clamp(0, t.shape[1] - 1)]


def seed_round1_torch(di: DeviceIndex, qbuf, nf, nr, nvf, lens, minseed: int,
                      M: int, work=None):
    """Plain version of round 1, the zigzag sweep
    (bwameme_tpu/seeding/engine.py:1081 _build_fused_step1)."""
    dev = lens.device
    R = lens.shape[0]
    lanes = torch.arange(R, device=dev)
    nf, nr, nvf, l = nf.to(I64), nr.to(I64), nvf.to(I64), lens.to(I64)

    def skip_ns(pivot):
        q = _tab(nvf, lanes, pivot)
        done_n = (q > pivot) & (q - 1 >= l - minseed + 1)
        return (pivot >= l) | done_n | (q >= l), q

    def enter_outer(pivot):
        done, q = skip_ns(pivot)
        prev_valid = (q != 0) & (_tab(nf, lanes, q - 1) != q - 1)
        phase = torch.where(done, DONE, torch.where(prev_valid, LEFT, RIGHT0))
        return phase, q

    phase, p = enter_outer(torch.zeros(R, dtype=I64, device=dev))
    phase = torch.where(l < minseed, DONE, phase)
    spb = p.clone()
    out = _Emitter(R, M, dev, di.rank_dtype)
    while bool((phase != DONE).any()):
        active = phase != DONE
        is_left = phase == LEFT
        lp = l - 1 - p
        row = torch.where(is_left, R + lanes, lanes)
        piv = torch.where(active, torch.where(is_left, lp, p), 0)
        v_raw = torch.where(is_left, _tab(nr, lanes, lp) - lp,
                            _tab(nf, lanes, p) - p)
        v = torch.where(active, v_raw, 0)
        # the zigzag reads the interval only of what it emits
        mlen, lb, cnt = ss.sa_query_min1(
            di, qbuf, row, piv, v, work,
            torch.where(is_left, NEVER, minseed))
        out.emit(active & ~is_left & (mlen >= minseed), p, p + mlen, lb, cnt)

        p2 = p - mlen + 1
        ph_l = torch.where(l - p2 < minseed, DONE, RIGHT_Z)
        sp = p + mlen
        sp = torch.where(sp <= spb, spb + 1, sp)   # progress guard
        done_z, q_z = skip_ns(sp)
        ph_z = torch.where(done_z, DONE, LEFT)
        ph_0, q_0 = enter_outer(p + mlen.clamp_min(1))
        is_z, is_0 = phase == RIGHT_Z, phase == RIGHT0
        new_phase = torch.where(is_left, ph_l, torch.where(is_z, ph_z, ph_0))
        new_p = torch.where(is_left, p2, torch.where(is_z, q_z, q_0))
        new_spb = torch.where(is_z, q_z, torch.where(is_0, q_0, spb))
        phase = torch.where(active, new_phase, phase)
        p = torch.where(active, new_p, p)
        spb = torch.where(active, new_spb, spb)
    return out.result()


def seed_round2_torch(di: DeviceIndex, qbuf, nf, nr, lens, slots1, nsm1,
                      split_len: int, split_width: int, minseed: int, M: int,
                      work=None):
    """Plain version of round 2, reseeding from the middle of round 1's long
    and rare SMEMs at min_intv = hitcount + 1
    (bwameme_tpu/seeding/engine.py:823 _build_fused_step2b). Each read walks
    its round-1 slots in order and runs one reseed at a time."""
    CURSOR, RLEN, LEFT2, REMZ, REM, DONE2 = 0, 1, 2, 3, 4, 5
    dev = lens.device
    R = lens.shape[0]
    M1 = slots1.shape[2]
    lanes = torch.arange(R, device=dev)
    nf, nr, l = nf.to(I64), nr.to(I64), lens.to(I64)
    st1, en1, cn1 = slots1[0].to(I64), slots1[1].to(I64), slots1[3].to(I64)
    ks = torch.arange(M1, device=dev)[None, :]
    piv_all = (st1 + en1) >> 1
    lanes2 = lanes[:, None].expand(R, M1)
    qual = ((ks < nsm1.to(I64)[:, None]) & (en1 - st1 >= split_len)
            & (cn1 <= split_width) & (_tab(nf, lanes2, piv_all) != piv_all))
    pv_all = (piv_all > 0) & (_tab(nf, lanes2, piv_all - 1) != piv_all - 1)

    zeros = torch.zeros(R, dtype=I64, device=dev)
    phase = torch.full((R,), CURSOR, dtype=I64, device=dev)
    k, p, npv, psp = zeros.clone(), zeros.clone(), zeros.clone(), zeros.clone()
    mi = torch.ones(R, dtype=I64, device=dev)
    out = _Emitter(R, M, dev, di.rank_dtype)
    while True:
        # cursor lanes move to their next qualifying slot, or finish
        is_cur = phase == CURSOR
        k_next = torch.where(qual & (ks >= k[:, None]), ks, M1).min(1).values
        has = is_cur & (k_next < M1)
        kc = k_next.clamp(max=M1 - 1)
        piv = piv_all[lanes, kc]
        phase = torch.where(
            is_cur, torch.where(has, torch.where(pv_all[lanes, kc], RLEN,
                                                 REM), DONE2), phase)
        k = torch.where(has, k_next, k)
        p = torch.where(has, piv, p)
        psp = torch.where(has, piv, psp)
        mi = torch.where(has, cn1[lanes, kc] + 1, mi)
        if bool((phase == DONE2).all()):
            break

        active = phase != DONE2
        is_left = phase == LEFT2
        lp = l - 1 - p
        row = torch.where(is_left, R + lanes, lanes)
        piv_q = torch.where(active, torch.where(is_left, lp, p), 0)
        v_raw = torch.where(is_left, _tab(nr, lanes, lp) - lp,
                            _tab(nf, lanes, p) - p)
        v = torch.where(active, v_raw, 0)
        mlen, lb, cnt = ss.sa_query(di, qbuf, row, piv_q, v, mi, work)
        out.emit(active & ((phase == REMZ) | (phase == REM))
                 & (mlen >= minseed), p, p + mlen, lb, cnt)

        npv_rlen = p + mlen
        ph_rlen = torch.where(p < npv_rlen, LEFT2, CURSOR)
        p2 = p - mlen + 1
        ph_left = torch.where(npv - p2 >= minseed, REMZ, CURSOR)
        sp = p + mlen
        sp = torch.where(sp <= psp, psp + 1, sp)   # progress guard
        ph_remz = torch.where(sp < npv, LEFT2, CURSOR)
        is_rlen, is_remz = phase == RLEN, phase == REMZ
        new_phase = torch.where(
            is_rlen, ph_rlen, torch.where(
                is_left, ph_left, torch.where(is_remz, ph_remz, CURSOR)))
        new_p = torch.where(is_left, p2, torch.where(is_remz, sp, p))
        npv = torch.where(active & is_rlen, npv_rlen, npv)
        psp = torch.where(active & is_remz, sp, psp)
        p = torch.where(active, new_p, p)
        # a finished reseed returns its read to the cursor, one slot on
        k = torch.where(active & (new_phase == CURSOR), k + 1, k)
        phase = torch.where(active, new_phase, phase)
    return out.result()


def _third_round_core(di: DeviceIndex, qbuf, row, pivot, v, min_intv: int,
                      min_seed: int, work=None):
    """The level walk at one pivot per lane
    (bwameme_tpu/seeding/engine.py:1367 third_round_core): (emit, e_len,
    e_lb, e_cnt, advance)."""
    ctx = ss.make_ctx(qbuf, row, pivot)
    lmax, _ = ss.find_longest_ctx(di, ctx, v.clamp_min(1), work, v > 0)
    lmax = torch.where(v <= 0, 0, lmax)
    done = lmax < min_seed
    cur_l = lmax.clamp_min(1)
    lb, cnt = ss.interval_at_ctx(di, ctx, cur_l, work, ~done)
    prev_lb, prev_cnt = torch.zeros_like(lb), torch.zeros_like(cnt)
    emit = torch.zeros_like(done)
    e_len, e_lb, e_cnt = (torch.zeros_like(lb) for _ in range(3))
    advance = torch.where(done, min_seed, 0)
    while not bool(done.all()):
        fire_sat = ~done & (cnt >= min_intv)
        emit_sat = fire_sat & (prev_cnt > 0)
        emit = emit | emit_sat
        e_len = torch.where(emit_sat, cur_l + 1, e_len)
        e_lb = torch.where(emit_sat, prev_lb, e_lb)
        e_cnt = torch.where(emit_sat, prev_cnt, e_cnt)
        advance = torch.where(fire_sat, cur_l + 1, advance)
        done = done | fire_sat

        _, l0 = ss.cmp_ctx(di, ctx, cur_l, lb - 1, work, ~done)
        _, l1 = ss.cmp_ctx(di, ctx, cur_l, lb + cnt, work, ~done)
        nxt = torch.maximum(l0, l1)
        fire_low = ~done & (nxt < min_seed)
        emit = emit | fire_low
        e_len = torch.where(fire_low, min_seed, e_len)
        e_lb = torch.where(fire_low, lb, e_lb)
        e_cnt = torch.where(fire_low, cnt, e_cnt)
        advance = torch.where(fire_low, min_seed, advance)
        done = done | fire_low

        go = ~done
        cur_l = torch.where(go, nxt.clamp_min(1), cur_l)
        lb2, cnt2 = ss.interval_at_ctx(di, ctx, cur_l, work, go)
        prev_lb = torch.where(go, lb, prev_lb)
        prev_cnt = torch.where(go, cnt, prev_cnt)
        lb = torch.where(go, lb2, lb)
        cnt = torch.where(go, cnt2, cnt)
    return emit, e_len, e_lb, e_cnt, advance


def seed_round3_torch(di: DeviceIndex, qbuf, nf, lens, min_intv: int,
                      min_seed: int, M: int, work=None):
    """Plain version of round 3, the bwt seed strategy
    (bwameme_tpu/seeding/engine.py:1281 _build_fused_step3)."""
    dev = lens.device
    R = lens.shape[0]
    lanes = torch.arange(R, device=dev)
    nf = nf.to(I64)
    lim = lens.to(I64) - min_seed + 1

    def resolve_skips(pv, done):
        # pass N pivots and valid windows shorter than a seed
        while True:
            done = done | (pv >= lim)
            v = _tab(nf, lanes, pv) - pv
            need = ~done & (v < min_seed)
            if not bool(need.any()):
                return pv, done
            pv = torch.where(need, pv + v.clamp_min(1), pv)

    pv, done = resolve_skips(torch.zeros(R, dtype=I64, device=dev), lim <= 0)
    out = _Emitter(R, M, dev, di.rank_dtype)
    while not bool(done.all()):
        v = torch.where(done, 0, _tab(nf, lanes, pv) - pv)
        piv = torch.where(done, 0, pv)
        emit, e_len, e_lb, e_cnt, advance = _third_round_core(
            di, qbuf, lanes, piv, v, min_intv, min_seed, work)
        out.emit(emit & ~done, pv, pv + e_len, e_lb, e_cnt)
        pv = torch.where(done, pv, pv + advance.clamp_min(1))
        pv, done = resolve_skips(pv, done)
    return out.result()


# ---------------------------------------------------------------- dispatch


def seed_round1(di: DeviceIndex, qbuf, nf, nr, nvf, lens, minseed: int,
                M: int):
    fn = (seed_smem_cuda.seed_round1 if _on_cuda(qbuf) else seed_round1_torch)
    return fn(di, qbuf, nf, nr, nvf, lens, minseed, M)


def seed_round2(di: DeviceIndex, qbuf, nf, nr, lens, slots1, nsm1,
                split_len: int, split_width: int, minseed: int, M: int):
    fn = (seed_smem_cuda.seed_round2 if _on_cuda(qbuf) else seed_round2_torch)
    return fn(di, qbuf, nf, nr, lens, slots1, nsm1, split_len, split_width,
              minseed, M)


def seed_round3(di: DeviceIndex, qbuf, nf, lens, min_intv: int,
                min_seed: int, M: int):
    fn = (seed_smem_cuda.seed_round3 if _on_cuda(qbuf) else seed_round3_torch)
    return fn(di, qbuf, nf, lens, min_intv, min_seed, M)


# ------------ the primitives alone, plain, in the form their kernels take


def prmi_window_torch(di: DeviceIndex, khi, klo):
    """Plain version of seed_smem_cuda.prmi_window: (lo, hi) windows of n
    keys given as int32 storage of uint32 words, int32 (int64 over a wide
    index)."""
    lo, hi = ss.prmi_window(di, ss.words_u32(khi), ss.words_u32(klo))
    return lo.to(di.rank_dtype), hi.to(di.rank_dtype)


def kmer_window_torch(di: DeviceIndex, khi, klo):
    """Plain version of seed_smem_cuda.kmer_window, as prmi_window_torch."""
    lo, hi = ss.kmer_window(di, ss.words_u32(khi), ss.words_u32(klo))
    return lo.to(di.rank_dtype), hi.to(di.rank_dtype)


def sa_query_torch(di: DeviceIndex, qbuf, row, pivot, v, min_intv,
                   work=None):
    """Plain version of seed_smem_cuda.sa_query: (3, n) mlen, lb, cnt of n
    (row, pivot, v, min_intv) jobs given as int32 tensors, int32 (int64
    over a wide index)."""
    return torch.stack(ss.sa_query(
        di, qbuf, row.to(I64), pivot.to(I64), v.to(I64),
        min_intv.to(I64), work)).to(di.rank_dtype)


# ------------------------------------------------------------------- pack


def pack_rounds(rounds, cap: int) -> torch.Tensor:
    """Compact the rounds' emission slots into one flat buffer of the slots'
    dtype (int64 carries a wide index's sa_lo and hitcount), grouped
    by read, each read's entries in round then emission order (the sort-free
    variant of bwameme_tpu/seeding/engine.py:254-276: cumsum + scatter; the
    stable (start, end) order is restored on the host). Layout:
    [dropped total, counts (R), start << 10 | end (cap), sa_lo (cap),
    hitcount (cap)]. Entries past ``cap`` go to a dump slot; the counts tell
    the reader that it happened."""
    slots = torch.cat([s for s, _, _ in rounds], 2)        # (4, R, Mt)
    R = slots.shape[1]
    valid = torch.cat(
        [torch.arange(s.shape[2], device=s.device)[None, :] < n[:, None]
         for s, n, _ in rounds], 1)
    vflat = valid.reshape(-1)
    pos = torch.cumsum(vflat, 0) - 1
    tgt = torch.where(vflat, pos, cap).clamp(max=cap)
    flat = slots.reshape(4, -1)
    sten = (flat[0] << 10) | flat[1].clamp(max=1023)
    body = torch.zeros((3, cap + 1), dtype=slots.dtype, device=slots.device)
    body[:, tgt] = torch.stack([sten, flat[2], flat[3]])
    counts = valid.sum(1, dtype=slots.dtype)
    dropped = sum(d.sum(dtype=slots.dtype) for _, _, d in rounds)
    return torch.cat([dropped.reshape(1), counts, body[:, :cap].reshape(-1)])
