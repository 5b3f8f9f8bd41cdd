"""The FM-index files that ``index -a mem2`` writes, written fast.

index/fmindex.py is a copy of bwameme_tpu's, and its ``save_fm_index``
compresses the arrays (np.savez_compressed): 11.4 s for a 4 Mbp genome on a
CPU core, so some five minutes at 100 Mbp, most of it deflating the int64
suffix array, which compresses poorly. ``save_fm_index`` here writes the
same arrays under the same names into the same ``prefix.fmi.npz``,
uncompressed; np.load reads either, so ``load_fm_index`` of both packages
reads it unchanged. It is about twice the size on disk.
"""

from __future__ import annotations

import os

import numpy as np


def save_fm_index(prefix: str, fm) -> None:
    """``prefix.fmi.npz`` with index/fmindex.save_fm_index's arrays,
    uncompressed; written to a file of its own and renamed into place, so
    that no reader sees half of it."""
    tmp = f"{prefix}.fmi.{os.getpid()}.tmp.npz"
    np.savez(tmp, n=fm.n, count=fm.count, sentinel_index=fm.sentinel_index,
             bwt=fm.bwt, cp_count=fm.cp_count, cp_bits=fm.cp_bits, sa=fm.sa,
             sa_ms_byte=fm.sa_ms_byte, sa_ls_word=fm.sa_ls_word)
    os.replace(tmp, prefix + ".fmi.npz")
