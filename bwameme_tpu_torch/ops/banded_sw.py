"""Batched banded Smith-Waterman seed extension: dispatch and plain version.

The port of bwameme_tpu/ops/banded_sw.py. Each public function takes
tensors on one device: CUDA tensors go to the hand-written kernel
(ops/banded_sw_cuda.py, csrc/banded_sw.cu), CPU tensors to the plain PyTorch
version below, and any other device raises. There is no fallback from the
kernel to the plain version.

``sw_core_torch`` is a line-for-line port of ``_sw_core_xla`` (the whole
batch advances one target row per step, the in-row F chain is a
``torch.cummax`` after the affine transform u_j = t_j + j*e_ins). It is the
CPU path and the on-card reference the kernel is held to. Result contract
{score, qle, tle, gtle, gscore, max_off}, bit-exact with the scalar
ksw_extend2 contract of align/sw_scalar.py:sw_extend.

Packed text words stay int32 views of the uint32 words: torch has no uint32
shifts or compares, so ``decode_text`` widens the words it gathers to int64.
"""

from __future__ import annotations

import torch

from bwameme_tpu_torch.ops import banded_sw_cuda
from bwameme_tpu_torch.ops.banded_sw_cuda import SW_RESULT_ORDER

NEG_BIG = -(1 << 28)

# rows of an extension round's result (bwameme_tpu/ops/banded_sw.py:383)
EXT_ROUND_ORDER = SW_RESULT_ORDER + ("w_used", "h0")


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"banded SW runs on CUDA or the CPU, not {x.device}")
    return False


def banded_sw_extend_batch(q_codes, t_codes, qlen, tlen, h0, ws, mat,
                           o_del: int, e_del: int, o_ins: int, e_ins: int,
                           end_bonus: int, zdrop: int):
    """Pair form: q (B,Q) and t (B,T) int32 codes 0-4, (B,) int32 qlen,
    tlen, h0 and band widths, mat (5,5) int32. Returns a dict of (B,) int32
    score, qle, tle, gtle, gscore, max_off."""
    fn = (banded_sw_cuda.banded_sw_pairs if _on_cuda(q_codes)
          else sw_core_torch)
    return fn(q_codes, t_codes, qlen, tlen, h0, ws, mat,
              o_del, e_del, o_ins, e_ins, end_bonus, zdrop)


def sw_core_torch(q_codes, t_codes, qlen, tlen, h0, ws, mat,
                  o_del: int, e_del: int, o_ins: int, e_ins: int,
                  end_bonus: int, zdrop: int):
    """Plain version of the banded-SW kernel (bwameme_tpu/ops/banded_sw.py:
    _sw_core_xla) on any device."""
    dev = q_codes.device
    i32 = torch.int32
    B, Q = q_codes.shape
    T = t_codes.shape[1]
    W = Q + 2  # eh arrays are indexed 0..qlen (+1 guard)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    h0 = h0.to(i32)
    mat = mat.to(i32)

    jj = torch.arange(W, dtype=i32, device=dev).expand(B, W)
    qlen_c = qlen[:, None]

    # per-pair band clamp in f32 (banded_sw_pallas.py:214-221)
    mx_sc = mat.max()
    max_ins = ((qlen * mx_sc + end_bonus - o_ins).to(torch.float32) / e_ins
               + 1.0).to(i32).clamp(min=1)
    max_del = ((qlen * mx_sc + end_bonus - o_del).to(torch.float32) / e_del
               + 1.0).to(i32).clamp(min=1)
    w_eff = torch.minimum(torch.minimum(ws.to(i32), max_ins), max_del)

    # first row
    v = h0[:, None] - oe_ins - (jj - 1) * e_ins
    ehh = torch.where(jj == 0, h0[:, None], v.clamp(min=0))
    ehh = torch.where(jj <= qlen_c, ehh, 0)
    ehe = torch.zeros((B, W), dtype=i32, device=dev)

    # score profile qp[b, c, j] = mat[c, q[b, j]]
    qp = mat[:, q_codes.clamp(0, 4).long()].permute(1, 0, 2)  # (B, 5, Q)
    t_codes = t_codes.clamp(0, 4).long()

    beg = torch.zeros(B, dtype=i32, device=dev)
    end = qlen.clone()
    mx = h0.clone()
    max_i = torch.full((B,), -1, dtype=i32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gsc = max_i.clone()
    max_off = torch.zeros(B, dtype=i32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    neg_col = torch.full((B, 1), NEG_BIG, dtype=i32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)

    for i in range(T):
        active = (~done) & (i < tlen)
        beg_i = torch.maximum(beg, i - w_eff)
        end_i = torch.minimum(torch.minimum(end, i + w_eff + 1), qlen)
        begc, endc = beg_i[:, None], end_i[:, None]
        inband = (jj >= begc) & (jj < endc)

        tci = t_codes[:, min(i, T - 1)]
        scores_q = torch.gather(qp, 1, tci[:, None, None].expand(B, 1, Q))
        scores = torch.cat([scores_q[:, 0, :],
                            torch.zeros((B, W - Q), dtype=i32, device=dev)], 1)

        M = torch.where(ehh != 0, ehh + scores, 0)
        E = ehe
        h_pre = torch.maximum(M, E)

        # F scan: f_beg = 0; f_{j+1} = max(f_j - e_ins, max(M_j - oe_ins, 0))
        t_ins = (M - oe_ins).clamp(min=0)
        u = torch.where(inband, t_ins + jj * e_ins, NEG_BIG)
        cm = torch.cummax(u, dim=1).values
        cm_prev = torch.cat([neg_col, cm[:, :-1]], 1)
        f = torch.where(jj == begc, 0, cm_prev - (jj - 1) * e_ins).clamp(min=0)

        H = torch.where(inband, torch.maximum(h_pre, f), 0)
        e_next = torch.maximum(E - e_del, (M - oe_del).clamp(min=0))

        h1_init = torch.where(
            beg_i == 0, (h0 - (o_del + e_del * (i + 1))).clamp(min=0), 0)

        # row max and its last attaining column
        mrow = H.max(dim=1).values
        is_max = inband & (H == mrow[:, None])
        mj = torch.where(is_max, jj, -1).max(dim=1).values

        Hshift = torch.cat([zero_col, H[:, :-1]], 1)
        sel_mid = (jj >= begc + 1) & (jj <= endc)
        ehh_new = torch.where(sel_mid, Hshift, ehh)
        ehh_new = torch.where(jj == begc, h1_init[:, None], ehh_new)
        ehe_new = torch.where(inband, e_next, ehe)
        ehe_new = torch.where(jj == endc, 0, ehe_new)

        # gscore: h1 after the row = H(i, end-1)
        h_at_end = torch.gather(H, 1, (end_i - 1).clamp(min=0)[:, None].long())
        h_end = torch.where(end_i > beg_i, h_at_end[:, 0], h1_init)
        upd_g = active & (end_i == qlen) & (gsc <= h_end)
        max_ie = torch.where(upd_g, i, max_ie)
        gsc = torch.where(upd_g, h_end, gsc)

        # termination + max update
        break0 = mrow == 0
        improved = mrow > mx
        di = (i - max_i) - (mj - max_j)
        zval = torch.where(di > 0, mx - mrow - di * e_del,
                           mx - mrow + di * e_ins)
        breakz = (~improved) & (zdrop > 0) & (zval > zdrop)

        upd_m = active & improved
        mx = torch.where(upd_m, mrow, mx)
        max_i = torch.where(upd_m, i, max_i)
        max_j = torch.where(upd_m, mj, max_j)
        max_off = torch.where(upd_m,
                              torch.maximum(max_off, (mj - i).abs()), max_off)

        terminated = active & (break0 | breakz)
        done = done | terminated | ((i + 1) >= tlen)

        # band pruning on the new state
        nz = (ehh_new != 0) | (ehe_new != 0)
        first_nz = torch.where(inband & nz, jj, 1 << 28).min(dim=1).values
        beg_new = torch.minimum(first_nz, end_i)
        in_hi = (jj >= beg_new[:, None]) & (jj <= endc)
        last_nz = torch.where(in_hi & nz, jj,
                              beg_new[:, None] - 1).max(dim=1).values
        end_new = torch.minimum(last_nz + 2, qlen)

        keep = active & (~terminated)
        ehh = torch.where(keep[:, None], ehh_new, ehh)
        ehe = torch.where(keep[:, None], ehe_new, ehe)
        beg = torch.where(keep, beg_new, beg)
        end = torch.where(keep, end_new, end)

    return dict(score=mx, qle=max_j + 1, tle=max_i + 1, gtle=max_ie + 1,
                gscore=gsc, max_off=max_off)


def decode_text(text32, start, ln, reverse: bool, T: int):
    """(N, T) int32 codes of text[start : start+ln], reversed on the left
    side; positions >= ln are 0. text32 is the int32 view of the packed
    uint32 words (16 bases per word, MSB first). Port of _decode_text."""
    dev = text32.device
    N = start.shape[0]
    Wt = T // 16 + 2
    s = start.long().clamp(min=0)
    widx = ((s >> 4)[:, None] + torch.arange(Wt, device=dev)).clamp(
        0, text32.numel() - 1)
    words = text32[widx].long() & 0xFFFFFFFF
    sh = (15 - torch.arange(16, device=dev)) * 2
    flat = ((words[:, :, None] >> sh) & 3).reshape(N, Wt * 16)
    jj = torch.arange(T, device=dev)
    ln = ln.long()[:, None]
    rel = (ln - 1 - jj) if reverse else jj.expand(N, T)
    idx = ((s & 15)[:, None] + rel).clamp(0, Wt * 16 - 1)
    out = torch.gather(flat, 1, idx)
    return torch.where(jj < ln, out, 0).to(torch.int32)


def gather_query(codes, row, start, ln, reverse: bool, Q: int):
    """(N, Q) int32 query codes from the (R, L) read-code matrix, reversed
    on the left side; positions >= ln are 0. Port of _gather_query."""
    R, L = codes.shape
    N = row.shape[0]
    rows = codes[row.long().clamp(0, R - 1)]  # (N, L)
    jj = torch.arange(Q, device=codes.device)
    ln = ln.long()[:, None]
    rel = (ln - 1 - jj) if reverse else jj.expand(N, Q)
    idx = (start.long()[:, None] + rel).clamp(0, L - 1)
    q = torch.gather(rows, 1, idx).to(torch.int32)
    return torch.where(jj < ln, q, 0)


def retry_select(res1, res2, w1: int, w2: int, prev):
    """The band-doubling retry rule per lane: round 2 replaces round 1 iff
    round 1 changed the score (prev: the alnreg score entering the round) and
    its max_off reached the band threshold. Port of _retry_select."""
    use2 = (res1["score"] != prev) & (res1["max_off"] >= ((w1 >> 1) + (w1 >> 2)))
    out = {k: torch.where(use2, res2[k], res1[k]) for k in res1}
    out["w_used"] = torch.where(use2, w2, w1).to(torch.int32)
    return out


def extend_side_round(text32, codes, mat, score_reg, jobs,
                      o_del: int, e_del: int, o_ins: int, e_ins: int,
                      end_bonus: int, zdrop: int, reverse: bool,
                      write_scores: bool = False):
    """One side of one extension round in coordinates (port of
    extend_side_round plus, with write_scores, scatter_scores).

    jobs (7, N) int32 rows reg, row, qstart, qlen, tstart, tlen, ws; h0 of a
    job is score_reg[clamp(reg, 0, Gp-1)]. With write_scores, score_reg[reg]
    = score in place for reg in [0, Gp): the left launch leaves the table the
    right launch reads its h0 from. Returns (8, N) int32 rows
    EXT_ROUND_ORDER."""
    fn = (banded_sw_cuda.banded_sw_coord if _on_cuda(jobs)
          else extend_side_round_torch)
    return fn(text32, codes, jobs, score_reg, mat, o_del, e_del, o_ins,
              e_ins, end_bonus, zdrop, reverse, write_scores)


def extend_side_round_torch(text32, codes, jobs, score_reg, mat,
                            o_del: int, e_del: int, o_ins: int, e_ins: int,
                            end_bonus: int, zdrop: int, reverse: bool,
                            write_scores: bool):
    """Plain version of the coordinate kernel on any device: decode_text +
    gather_query + sw_core_torch, then the score scatter."""
    reg, row, qstart, qlen, tstart, tlen, ws = jobs.unbind(0)
    Gp = score_reg.shape[0]
    Q = max(int(qlen.max()), 1) if qlen.numel() else 1
    T = max(int(tlen.max()), 1) if tlen.numel() else 1
    q = gather_query(codes, row, qstart, qlen, reverse, Q)
    t = decode_text(text32, tstart, tlen, reverse, T)
    h0 = score_reg[reg.long().clamp(0, Gp - 1)]
    res = sw_core_torch(q, t, qlen, tlen, h0, ws, mat,
                        o_del, e_del, o_ins, e_ins, end_bonus, zdrop)
    if write_scores:
        ok = (reg >= 0) & (reg < Gp)
        score_reg[reg[ok].long()] = res["score"][ok]
    return torch.stack([res[k] for k in SW_RESULT_ORDER] + [ws, h0])
