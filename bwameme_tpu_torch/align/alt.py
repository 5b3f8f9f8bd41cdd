"""XA-tag generation for shadowed alternative hits.

The port's copy of bwameme_tpu/align/alt.py over the port's AlnReg.

Replicates mem_gen_alt + get_pri_idx (reference: src/bwamem_extra.cpp:122-183):
each secondary hit within XA_drop_ratio of its primary contributes a
"chr,±pos,cigar,NM;" entry to the primary's XA string, capped at
max_XA_hits(_alt)."""

from __future__ import annotations

import numpy as np

from bwameme_tpu_torch.align.extend import AlnReg
from bwameme_tpu_torch.align.finalize import reg2aln


def _get_pri_idx(xa_drop_ratio: float, a: list[AlnReg], i: int) -> int:
    k = a[i].secondary_all
    if k >= 0 and a[i].score >= a[k].score * xa_drop_ratio:
        return k
    return -1


def gen_alt(opt, bns, text: np.ndarray, regs: list[AlnReg], l_query: int,
            query: np.ndarray) -> list[str | None]:
    """Returns an XA string (or None) per alnreg index. Call after
    mark_primary."""
    n = len(regs)
    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if regs[i].is_alt:
                has_alt[r] = True
    XA: list[str | None] = [None] * n
    if tot == 0:
        return XA
    parts: list[list[str]] = [[] for _ in range(n)]
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
        if r < 0:
            continue
        if cnt[r] > opt.max_XA_hits_alt or (not has_alt[r] and cnt[r] > opt.max_XA_hits):
            continue
        t = reg2aln(opt, bns, text, l_query, query, regs[i])
        cig = "".join(f"{ln}{'MIDSHN'[op]}" for op, ln in (t.cigar or []))
        parts[r].append(
            f"{bns.contigs[t.rid].name},{'-' if t.is_rev else '+'}{t.pos + 1},"
            f"{cig},{t.NM};"
        )
    for r in range(n):
        if parts[r]:
            XA[r] = "".join(parts[r])
    return XA
