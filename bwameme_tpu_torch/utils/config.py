"""Alignment option block — the analog of the reference's ``mem_opt_t``.

Defaults mirror ``mem_opt_init`` (reference: src/bwamem.cpp:126-162) so that the
numerical contracts of every downstream stage (seeding thresholds, chaining
rules, Smith-Waterman scoring, mapq) match bwa-mem 0.7.17 / bwa-mem2 semantics.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def fill_scmat(a: int, b: int) -> np.ndarray:
    """5x5 DNA scoring matrix (A,C,G,T,N): match=+a, mismatch=-b, N row/col=-1.

    Semantics of ``bwa_fill_scmat`` (reference: src/bwa.cpp).
    """
    mat = np.full((5, 5), -b, dtype=np.int8)
    np.fill_diagonal(mat, a)
    mat[4, :] = -1
    mat[:, 4] = -1
    return mat


@dataclasses.dataclass
class MemOptions:
    # scoring
    a: int = 1                 # match score
    b: int = 4                 # mismatch penalty
    o_del: int = 6             # gap open (deletion)
    e_del: int = 1             # gap extend (deletion)
    o_ins: int = 6             # gap open (insertion)
    e_ins: int = 1             # gap extend (insertion)
    pen_unpaired: int = 17     # penalty for unpaired read pairs
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100               # band width
    zdrop: int = 100           # Z-dropoff

    max_mem_intv: int = 20

    T: int = 30                # output score threshold
    flag: int = 0              # MEM_F_* bit flags
    min_seed_len: int = 19
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    split_factor: float = 1.5
    split_width: int = 10
    max_occ: int = 500
    max_chain_gap: int = 10000
    n_threads: int = 1
    chunk_size: int = 10000000
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    XA_drop_ratio: float = 0.80
    mask_level_redun: float = 0.95
    mapQ_coef_len: float = 50.0
    max_ins: int = 10000
    max_matesw: int = 50
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 200

    def __post_init__(self) -> None:
        self.mapQ_coef_fac = int(math.log(self.mapQ_coef_len))
        self.mat = fill_scmat(self.a, self.b)

    @property
    def split_len(self) -> int:
        """Reseeding length threshold: int(min_seed_len * split_factor + .499)."""
        return int(self.min_seed_len * self.split_factor + 0.499)

    def update_a(self, scaled_a: int) -> None:
        """Rescale all penalties when -A changes (reference: src/fastmap.cpp:1126-1140)."""
        ratio = scaled_a
        self.b *= ratio
        self.T *= ratio
        self.o_del *= ratio
        self.e_del *= ratio
        self.o_ins *= ratio
        self.e_ins *= ratio
        self.zdrop *= ratio
        self.pen_clip5 *= ratio
        self.pen_clip3 *= ratio
        self.pen_unpaired *= ratio
        self.a = scaled_a
        self.mat = fill_scmat(self.a, self.b)


# MEM_F_* flags (reference: src/bwamem.h:66-80)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_REF_HDR = 0x100
MEM_F_SOFTCLIP = 0x200
MEM_F_SMARTPE = 0x400
MEM_F_PRIMARY5 = 0x800
MEM_F_KEEP_SUPP_MAPQ = 0x1000
MEM_F_XB = 0x2000

MEM_MAPQ_MAX = 60
