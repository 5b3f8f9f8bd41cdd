"""FM-index over the forward+RC text — the reference's default seeding index.

TPU-native analog of FMI_search::build_index / load_index (reference:
src/FMI_search.cpp:308-470). Structures:

* ``textF`` = forward 2-bit codes + reverse complement (NO T-padding — the
  FM-index uses sentinel semantics, exactly like the reference, which indexes
  text+RC+'$'). textF is its own reverse complement, which is what makes the
  bidirectional SMEM trick work (forward extension = backward extension of
  the complement on the same index).
* suffix array in sentinel coordinates: rank 0 is the '$' suffix, ranks
  1..N are the N text suffixes in sentinel order (shorter-prefix-first).
* BWT with the sentinel character (code 4) at ``sentinel_index`` — the rank
  of the whole-text suffix (reference: FMI_search.cpp:470-489).
* checkpointed occ: per 64-base block, running counts ``cp_count[4]`` plus a
  one-hot 64-bit bitmap per base stored as two uint32 words (the TPU gather/
  popcount layout of the reference's CP_OCC, src/FMI_search.h:54-58).
* suffix positions, both flat (int64[N+1]) and 1/8-compressed (ms_byte +
  ls_word every 8th rank, reference SA_COMPX=3 layout, FMI_search.cpp:392-470)
  for the LF-walk lookup path.

Counts convention (reference: smem init k=count[a], l=count[3-a],
s=count[a+1]-count[a], FMI_search.cpp:522-529): count[b] = 1 + #chars < b
in textF (the +1 is the sentinel suffix at rank 0), count[4] = N+1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bwameme_tpu_torch.index.suffix_array import build_suffix_array

CP_SHIFT = 6                    # 64-base occ checkpoint blocks
CP_BLOCK = 1 << CP_SHIFT
SA_COMPX = 3                    # keep every 8th SA entry in compressed mode
SA_COMPX_MASK = (1 << SA_COMPX) - 1
CP_FILENAME_SUFFIX = ".bwt.2bit.64"


@dataclasses.dataclass
class FmIndex:
    n: int                      # len(textF) (= 2 * l_pac)
    count: np.ndarray           # int64[5]; count[b] = rank start of char b
    sentinel_index: int         # rank whose BWT char is '$'
    bwt: np.ndarray             # uint8[n+1] (code 4 at sentinel_index)
    cp_count: np.ndarray        # int64[nb, 4] occ at block starts
    cp_bits: np.ndarray         # uint32[nb, 4, 2] one-hot block bitmaps
    sa: np.ndarray              # int64[n+1] suffix positions (rank 0 -> n)
    sa_ms_byte: np.ndarray      # int8[(n>>3)+1] compressed SA high bytes
    sa_ls_word: np.ndarray      # uint32[...] compressed SA low words
    # per-base sorted occurrence ranks (host occ via searchsorted)
    occ_ranks: list[np.ndarray] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------- queries
    def occ(self, b: int, p) -> np.ndarray:
        """#occurrences of base b in bwt[0:p) (sentinel never counted)."""
        return np.searchsorted(self.occ_ranks[b], p)

    def get_sa_entry(self, rank: int) -> int:
        return int(self.sa[rank])

    def get_sa_entry_compressed(self, rank: int) -> int:
        """LF-walk until the rank is a stored checkpoint (reference:
        FMI_search.cpp:1117-1180)."""
        offset = 0
        sp = int(rank)
        while sp & SA_COMPX_MASK:
            b = int(self.bwt[sp])
            if b == 4:  # sentinel: this rank IS position 0 + offset walked
                return offset
            sp = int(self.count[b] + self.occ(b, sp))
            offset += 1
        hi = int(self.sa_ms_byte[sp >> SA_COMPX])
        lo = int(self.sa_ls_word[sp >> SA_COMPX])
        return ((hi << 32) | lo) + offset


def build_fm_index(code: np.ndarray) -> FmIndex:
    """code: uint8[l_pac] forward 2-bit codes (0..3)."""
    code = np.asarray(code, dtype=np.uint8)
    rc = (3 - code[::-1]).astype(np.uint8)
    textF = np.concatenate([code, rc])
    n = len(textF)

    sa_body = build_suffix_array(textF)          # sentinel semantics
    sa = np.empty(n + 1, dtype=np.int64)
    sa[0] = n                                    # the '$' suffix
    sa[1:] = sa_body

    bwt = np.empty(n + 1, dtype=np.uint8)
    prev = sa - 1
    nonzero = sa > 0
    bwt[nonzero] = textF[prev[nonzero]]
    sent = int(np.flatnonzero(sa == 0)[0])
    bwt[sent] = 4

    base_counts = np.bincount(textF, minlength=4)[:4].astype(np.int64)
    count = np.empty(5, dtype=np.int64)
    count[0] = 1
    np.cumsum(base_counts, out=count[1:])
    count[1:] += 1

    nb = (n + 1 + CP_BLOCK - 1) // CP_BLOCK
    onehot = np.zeros((4, nb * CP_BLOCK), dtype=bool)
    for b in range(4):
        onehot[b, : n + 1] = bwt == b
    cp_count = np.zeros((nb, 4), dtype=np.int64)
    cums = np.cumsum(onehot, axis=1)
    if nb > 1:
        cp_count[1:, :] = cums[:, CP_BLOCK - 1 :: CP_BLOCK][:, : nb - 1].T
    # bitmap: offset o -> word o>>5, bit (31 - (o&31)) (MSB-first)
    blocks = onehot.reshape(4, nb, 2, 32)
    weights = (np.uint32(1) << np.uint32(31 - np.arange(32))).astype(np.uint32)
    cp_bits = np.einsum("bnwo,o->bnw", blocks.astype(np.uint64), weights.astype(np.uint64))
    cp_bits = np.ascontiguousarray(cp_bits.transpose(1, 0, 2)).astype(np.uint32)

    n_comp = ((n + 1) >> SA_COMPX) + 1
    comp_idx = np.arange(n_comp, dtype=np.int64) << SA_COMPX
    comp_idx = comp_idx[comp_idx <= n]
    sa_comp = sa[comp_idx]
    sa_ms_byte = (sa_comp >> 32).astype(np.int8)
    sa_ls_word = (sa_comp & 0xFFFFFFFF).astype(np.uint32)

    occ_ranks = [np.flatnonzero(bwt == b).astype(np.int64) for b in range(4)]

    return FmIndex(
        n=n, count=count, sentinel_index=sent, bwt=bwt,
        cp_count=cp_count, cp_bits=cp_bits, sa=sa,
        sa_ms_byte=sa_ms_byte, sa_ls_word=sa_ls_word, occ_ranks=occ_ranks,
    )


def write_bwt_2bit_64(fm: FmIndex, prefix: str) -> None:
    """Write the reference's ``.bwt.2bit.64`` FM-index file, byte-compatible
    with FMI_search::build_fm_index (reference: src/FMI_search.cpp:140-300):

      int64 ref_seq_len (= n+1, text+RC+sentinel)
      int64 count[5]    (cumulative char starts WITHOUT the +1 the loader adds)
      CP_OCC[(len>>6)+1]: {int64 cp_count[4]; uint64 one_hot[4]} per 64-base
                          block, one-hot MSB-first
      int8  sa_ms_byte[(len>>3)+1]; uint32 sa_ls_word[...]  (every 8th rank)
      int64 sentinel_index
    """
    n1 = fm.n + 1
    nb_file = (n1 >> CP_SHIFT) + 1
    with open(prefix + CP_FILENAME_SUFFIX, "wb") as f:
        np.int64(n1).tofile(f)
        (fm.count.astype(np.int64) - 1).tofile(f)

        cp = np.zeros((nb_file, 8), dtype=np.uint64)
        nb = fm.cp_count.shape[0]
        cp[:nb, :4] = fm.cp_count.astype(np.int64).view(np.uint64)
        # one_hot uint64 = (word0 << 32) | word1  (word0 = first 32 bases)
        bits = fm.cp_bits.astype(np.uint64)
        cp[:nb, 4:] = (bits[:, :, 0] << np.uint64(32)) | bits[:, :, 1]
        cp.tofile(f)

        n_comp = (n1 >> SA_COMPX) + 1
        ms = np.zeros(n_comp, dtype=np.int8)
        ls = np.zeros(n_comp, dtype=np.uint32)
        ms[: len(fm.sa_ms_byte)] = fm.sa_ms_byte
        ls[: len(fm.sa_ls_word)] = fm.sa_ls_word
        ms.tofile(f)
        ls.tofile(f)
        np.int64(fm.sentinel_index).tofile(f)


def read_bwt_2bit_64(prefix: str) -> FmIndex:
    """Load a reference-built ``.bwt.2bit.64`` (FMI_search::load_index,
    src/FMI_search.cpp:392-470) and reconstruct the full FmIndex.

    The file stores only the 1/8-compressed SA; the full per-rank position
    table is regenerated with SA_COMPX vectorized LF-steps over all ranks
    at once (the batched analog of get_sa_entry_compressed's walk)."""
    with open(prefix + CP_FILENAME_SUFFIX, "rb") as f:
        n1 = int(np.fromfile(f, np.int64, 1)[0])
        count = np.fromfile(f, np.int64, 5) + 1
        nb_file = (n1 >> CP_SHIFT) + 1
        cp = np.fromfile(f, np.uint64, nb_file * 8).reshape(nb_file, 8)
        n_comp = (n1 >> SA_COMPX) + 1
        sa_ms_byte = np.fromfile(f, np.int8, n_comp)
        sa_ls_word = np.fromfile(f, np.uint32, n_comp)
        sentinel = int(np.fromfile(f, np.int64, 1)[0])
    n = n1 - 1
    nb = (n1 + CP_BLOCK - 1) // CP_BLOCK
    cp_count = cp[:nb, :4].view(np.int64).copy()
    onehot64 = cp[:nb, 4:]
    cp_bits = np.empty((nb, 4, 2), dtype=np.uint32)
    cp_bits[:, :, 0] = (onehot64 >> np.uint64(32)).astype(np.uint32)
    cp_bits[:, :, 1] = (onehot64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    # bwt chars back from the one-hot bitmaps
    shifts = np.uint64(63) - np.arange(64, dtype=np.uint64)
    planes = ((onehot64[:, :, None] >> shifts[None, None, :])
              & np.uint64(1)).astype(np.uint8)          # [nb, 4, 64]
    bwt_full = np.full(nb * CP_BLOCK, 4, dtype=np.uint8)
    for b in range(4):
        bwt_full[np.flatnonzero(planes[:, b, :].reshape(-1))] = b
    bwt = bwt_full[:n1].copy()
    bwt[sentinel] = 4

    # full SA by SA_COMPX_MASK batched LF-steps: ranks with a stored entry
    # resolve immediately; others step to LF(rank) and add 1
    occ_ranks = [np.flatnonzero(bwt == b).astype(np.int64) for b in range(4)]
    sa = np.zeros(n1, dtype=np.int64)
    rank = np.arange(n1, dtype=np.int64)
    offset = np.zeros(n1, dtype=np.int64)
    done = np.zeros(n1, dtype=bool)
    # LF lands on ~uniform ranks, so each step resolves ~1/8 of the
    # remainder (geometric, ~8 expected iterations); a walk is hard-bounded
    # by text length (it reaches the sentinel at position 0)
    for _ in range(n1 + 2):
        newly = np.flatnonzero(~done & ((rank & SA_COMPX_MASK) == 0))
        if len(newly):
            ri = rank[newly] >> SA_COMPX
            sa[newly] = (((sa_ms_byte[ri].astype(np.int64) & 0xFF) << 32)
                         | sa_ls_word[ri]) + offset[newly]
            done[newly] = True
        todo = np.flatnonzero(~done)
        if not len(todo):
            break
        r = rank[todo]
        b = bwt[r]
        sent = todo[b == 4]          # sentinel: position = steps walked
        sa[sent] = offset[sent]
        done[sent] = True
        for c in range(4):
            sel = todo[b == c]       # LF step: rank' = count[c] + occ(c, r)
            rank[sel] = count[c] + np.searchsorted(occ_ranks[c], rank[sel])
        offset[todo] += 1
    assert done.all()

    return FmIndex(
        n=n, count=count, sentinel_index=sentinel, bwt=bwt,
        cp_count=cp_count, cp_bits=cp_bits, sa=sa,
        sa_ms_byte=sa_ms_byte[: ((n1 - 1) >> SA_COMPX) + 1],
        sa_ls_word=sa_ls_word[: ((n1 - 1) >> SA_COMPX) + 1],
        occ_ranks=occ_ranks,
    )


def save_fm_index(prefix: str, fm: FmIndex) -> None:
    np.savez_compressed(
        prefix + ".fmi.npz",
        n=fm.n, count=fm.count, sentinel_index=fm.sentinel_index,
        bwt=fm.bwt, cp_count=fm.cp_count, cp_bits=fm.cp_bits, sa=fm.sa,
        sa_ms_byte=fm.sa_ms_byte, sa_ls_word=fm.sa_ls_word,
    )


def load_fm_index(prefix: str) -> FmIndex:
    z = np.load(prefix + ".fmi.npz")
    bwt = z["bwt"]
    return FmIndex(
        n=int(z["n"]), count=z["count"],
        sentinel_index=int(z["sentinel_index"]), bwt=bwt,
        cp_count=z["cp_count"], cp_bits=z["cp_bits"], sa=z["sa"],
        sa_ms_byte=z["sa_ms_byte"], sa_ls_word=z["sa_ls_word"],
        occ_ranks=[np.flatnonzero(bwt == b).astype(np.int64) for b in range(4)],
    )
