"""Library convenience APIs (reference: src/bwamem_extra.cpp).

The port's copy of bwameme_tpu/align/extra.py:

* ``align1`` — align one sequence and return its alignment regions, the
  analog of ``mem_align1`` (bwamem_extra.cpp:103-121): the one-call entry
  for library users who want regions rather than SAM text. Its extension
  runs the dataclass path of align/extend.py: on a CUDA device one
  ``banded_sw_pairs`` launch a band try and side, on the CPU the plain
  version.
* ``reg2ovlp`` — convert regions to simple overlap hits, the analog of
  ``mem_reg2ovlp`` (bwamem_extra.cpp:59-79): whole-read-span hits used by
  fastmap-style consumers (qb/qe widened to the full read, strand folded).

XA-tag generation (``mem_gen_alt``) lives in align/alt.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bwameme_tpu_torch.align import chain as chain_mod
from bwameme_tpu_torch.align import extend as extend_mod
from bwameme_tpu_torch.align import finalize
from bwameme_tpu_torch.index.packing import NT4_TABLE


@dataclasses.dataclass
class OvlpHit:
    rb: int
    re: int
    qb: int
    qe: int
    rid: int
    score: int
    is_rev: bool


def align1(idx, opt, seq: str, engine=None, device="cuda"):
    """Align one sequence; returns the deduped, primary-marked region list
    (mem_align1 semantics: full kernel-1/2 pipeline, no SAM conversion).
    ``engine``: any seeding engine (seeding/host_engine.SeedingEngine; the
    host engine by default, as in the JAX package). The extension runs on
    ``device``: the card unless the caller asks for the CPU; a missing CUDA
    device is an error, never a move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    codes = NT4_TABLE[np.frombuffer(seq.encode(), dtype=np.uint8)]
    if engine is None:
        from bwameme_tpu_torch.seeding.host_engine import HostSeedingEngine

        engine = HostSeedingEngine(idx, opt)
    smems = engine.sorted_smems(codes)
    chains = chain_mod.chain_seeds(opt, idx.bns, len(codes), smems,
                                   engine.sa_positions)
    chains = chain_mod.filter_chains(opt, chains)
    chain_mod.filter_chained_seeds(opt, idx.bns, idx.text, codes, len(codes),
                                   chains)
    regs = extend_mod.extend_chains_batch(opt, idx.bns, idx.text, [codes],
                                          [chains], device)[0]
    regs = [r for r in regs if r.qe > r.qb]
    regs = finalize.sort_dedup_patch(opt, idx.bns, idx.text, codes, regs)
    return finalize.mark_primary(opt, regs, 0)


def reg2ovlp(bns, l_query: int, regs) -> list[OvlpHit]:
    """Regions -> whole-read overlap hits (mem_reg2ovlp semantics: the hit
    spans the full read projected onto the reference; strand folded)."""
    out = []
    for r in regs:
        if r.score < 0 or r.rid < 0:
            continue
        rb = r.rb - r.qb                      # extend to whole-read span
        re = r.re + (l_query - r.qe)
        _pos_f, is_rev = bns.depos((rb + re) >> 1)
        out.append(OvlpHit(rb=rb, re=re, qb=0, qe=l_query, rid=r.rid,
                           score=r.score, is_rev=is_rev))
    return out
