"""Learned-index (P-RMI) index build.

TPU-native analog of the reference build path ``bwa-meme index -a meme``
(reference: src/bwtindex.cpp:344 bwa_idx_build_Learned_index +
src/Learnedindex.cpp:134 buildSAandLEP):

1. text = forward 2-bit codes + reverse complement + T-padding, where the
   padding length is max(longest A run, longest T run)+1 over text+RC
   (reference: src/Learnedindex.cpp:157-230).
2. suffix array over the padded text (native SA-IS), entries that fall in the
   padding are dropped (reference: src/Learnedindex.cpp:456-545).
3. per-SA-entry 32-base keys (2-bit, MSB-first, T-padded past the end) — the
   MODE2/3 "LOADSUFFIX" layout (reference: src/LearnedIndex_seeding.h:79-88),
   stored as two uint32 planes for TPU-friendly gathers.
4. inverse suffix array (``ref2sa``, MODE3 tradeoff feature, reference:
   src/fastmap.cpp:580-607).
5. P-RMI model trained in JAX (replaces the reference's Rust trainer, RMI/).

Artifacts are stored under ``<prefix>.meme/`` (one mmap-able .npy per
plane; legacy ``<prefix>.meme.npz`` still loads) plus the classic
``.pac/.ann/.amb`` from bntseq.dump.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bwameme_tpu_torch.index import bntseq as bnsmod
from bwameme_tpu_torch.index.bntseq import BntSeq
from bwameme_tpu_torch.index.packing import extract_key64, pack_words
from bwameme_tpu_torch.index.suffix_array import build_suffix_array


def build_text(code: np.ndarray) -> tuple[np.ndarray, int]:
    """forward + reverse-complement + T padding; returns (text, pad_len)."""
    if len(code) and code.max() > 3:
        # ambiguous bases must be resolved UPSTREAM (bntseq's lrand48 fill,
        # reference: src/bntseq.cpp) — a stray 4 becomes 255 in the RC half
        # and walks the native SA-IS off its bucket arrays
        raise ValueError(
            "build_text: code contains values > 3 (unresolved N bases?); "
            "run the sequence through bntseq first (N -> lrand48()&3)")
    rc = (3 - code[::-1]).astype(np.uint8)
    body = np.concatenate([code, rc])

    # longest run of A (0) and of T (3) over the concatenated text
    def longest_run(x: np.ndarray, v: int) -> int:
        m = np.r_[False, x == v, False]
        d = np.diff(m.astype(np.int8))
        starts = np.flatnonzero(d == 1)
        ends = np.flatnonzero(d == -1)
        return int((ends - starts).max()) if len(starts) else 0

    from bwameme_tpu_torch.align.native import longest_runs_native

    runs = longest_runs_native(body)
    if runs is None:
        runs = (longest_run(body, 0), longest_run(body, 3))
    pad = max(runs) + 1
    text = np.concatenate([body, np.full(pad, 3, dtype=np.uint8)])
    return text, pad


@dataclasses.dataclass
class MemeIndex:
    """HBM-resident learned index, ready to ship to device."""

    bns: BntSeq
    text: np.ndarray        # uint8 codes incl. RC + T-pad  (host, for oracles)
    text32: np.ndarray      # uint32 packed words of text (+2 guard words of T)
    sa: np.ndarray          # int64[n_sa] suffix positions (pad entries dropped)
    key_hi: np.ndarray      # uint32[n_sa] bases 0..15 of each suffix
    key_lo: np.ndarray      # uint32[n_sa] bases 16..31
    isa: np.ndarray | None  # int64[2*l_pac] inverse SA (MODE3), or None
    pad_len: int
    # P-RMI parameters (filled by models.prmi.train_prmi)
    rmi_bits: int = 0
    rmi_alpha: np.ndarray | None = None       # float32[n_leaves]
    rmi_beta: np.ndarray | None = None        # float32[n_leaves]
    rmi_err_lo: np.ndarray | None = None      # int32[n_leaves]
    rmi_err_hi: np.ndarray | None = None      # int32[n_leaves]
    rmi_leaf_start: np.ndarray | None = None  # int64[n_leaves+1]

    @property
    def l_pac(self) -> int:
        return self.bns.l_pac

    @property
    def n_sa(self) -> int:
        return len(self.sa)

    @property
    def max_err(self) -> int:
        return int(max(self.rmi_err_lo.max(), self.rmi_err_hi.max()))


def build_index(
    bns: BntSeq,
    with_isa: bool = True,
    rmi_bits: int | None = None,
    train: bool = True,
) -> MemeIndex:
    from bwameme_tpu_torch.align.native import filter_lt_native, invert_sa_native

    text, pad = build_text(bns.code)
    sa_full = build_suffix_array(text)
    n_keep = 2 * bns.l_pac
    sa = filter_lt_native(sa_full, n_keep)
    if sa is None:
        sa = sa_full[sa_full < n_keep]
    assert len(sa) == n_keep

    keys = extract_key64(text, sa, pad_code=3)
    key_hi = (keys >> np.uint64(32)).astype(np.uint32)
    key_lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    isa = None
    if with_isa:
        isa = invert_sa_native(sa)
        if isa is None:
            isa = np.empty(n_keep, dtype=np.int64)
            isa[sa] = np.arange(n_keep, dtype=np.int64)

    text32 = np.concatenate([
        pack_words(text, pad_code=3),
        np.full(12, 0xFFFFFFFF, dtype=np.uint32),  # guard words: all T
    ])

    idx = MemeIndex(
        bns=bns, text=text, text32=text32, sa=sa,
        key_hi=key_hi, key_lo=key_lo, isa=isa, pad_len=pad,
    )
    if train:
        from bwameme_tpu_torch.models.prmi import train_prmi

        if rmi_bits is None:
            # auto-size like build_rmis_dna.sh:64-109: aim for ~8-16 keys/leaf
            rmi_bits = max(8, min(28, int(np.ceil(np.log2(max(len(sa), 2)))) - 3))
        train_prmi(idx, rmi_bits)
    return idx


def build_from_fasta(fasta_path: str, **kw) -> MemeIndex:
    bns = bnsmod.fasta_to_bntseq(fasta_path)
    return build_index(bns, **kw)


_BIG_PLANES = ("text", "text32", "sa", "key_hi", "key_lo", "isa")


def save_index(idx: MemeIndex, prefix: str) -> None:
    """Persist under prefix+'.meme/' as one .npy per plane: big planes then
    load back MEMORY-MAPPED (np.load(..., mmap_mode='r')), the analog of
    the reference's 3-5 GB/s effective index load (README.md:10) — a
    zipped .npz must stream-copy every byte through Python (~50 MB/s on
    this host, 2+ min for a 100 Mbp index)."""
    import os

    bnsmod.dump(idx.bns, prefix)
    d = prefix + ".meme"
    os.makedirs(d, exist_ok=True)
    isa = idx.isa if idx.isa is not None else np.zeros(0, dtype=np.int64)
    for name, arr in (("text", idx.text), ("text32", idx.text32),
                      ("sa", idx.sa), ("key_hi", idx.key_hi),
                      ("key_lo", idx.key_lo), ("isa", isa)):
        np.save(os.path.join(d, name + ".npy"), arr)
    np.savez(
        os.path.join(d, "meta.npz"),
        pad_len=np.int64(idx.pad_len),
        rmi_bits=np.int64(idx.rmi_bits),
        rmi_alpha=idx.rmi_alpha, rmi_beta=idx.rmi_beta,
        rmi_err_lo=idx.rmi_err_lo, rmi_err_hi=idx.rmi_err_hi,
        rmi_leaf_start=idx.rmi_leaf_start,
    )


def load_index(prefix: str) -> MemeIndex:
    import os

    bns = bnsmod.restore(prefix)
    d = prefix + ".meme"
    if os.path.isdir(d):
        z = np.load(os.path.join(d, "meta.npz"))

        def plane(name):
            return np.load(os.path.join(d, name + ".npy"), mmap_mode="r")

        isa = plane("isa")
        return MemeIndex(
            bns=bns, text=plane("text"), text32=plane("text32"),
            sa=plane("sa"), key_hi=plane("key_hi"), key_lo=plane("key_lo"),
            isa=isa if len(isa) else None,
            pad_len=int(z["pad_len"]), rmi_bits=int(z["rmi_bits"]),
            rmi_alpha=z["rmi_alpha"], rmi_beta=z["rmi_beta"],
            rmi_err_lo=z["rmi_err_lo"], rmi_err_hi=z["rmi_err_hi"],
            rmi_leaf_start=z["rmi_leaf_start"],
        )
    # legacy single-file .npz layout
    z = np.load(prefix + ".meme.npz")
    isa = z["isa"]
    return MemeIndex(
        bns=bns, text=z["text"], text32=z["text32"], sa=z["sa"],
        key_hi=z["key_hi"], key_lo=z["key_lo"],
        isa=isa if len(isa) else None,
        pad_len=int(z["pad_len"]), rmi_bits=int(z["rmi_bits"]),
        rmi_alpha=z["rmi_alpha"], rmi_beta=z["rmi_beta"],
        rmi_err_lo=z["rmi_err_lo"], rmi_err_hi=z["rmi_err_hi"],
        rmi_leaf_start=z["rmi_leaf_start"],
    )
