"""ERT (enumerated radix tree) seeding backend — TPU-native formulation.

The reference's ERT index (src/ertindex.cpp/h) is a 4^15-entry k-mer table of
byte offsets into serialized multi-level radix trees whose leaves carry
reference positions inline (src/ertindex.h:53-67); queries walk the trees
byte-wise (src/ertseeding.cpp:2935-3435). The trick is twofold: (1) the first
k levels of the descent are a single direct table lookup, and (2) the
traversal never touches a suffix array.

On TPU the natural representation of a radix subtree over suffixes is the
*contiguous interval of the sorted suffix-key array*: descending one level ==
narrowing the interval by one base, and the leaf payload == the SA slice.
So the TPU-native ERT is:

  kmer_table[4^K + 1]  (int32 prefix boundaries into the sorted key array)
      -- the enumerated root: one gather replaces the P-RMI model predict
  sorted 32-base keys + packed text (already index-resident)
      -- the radix trees: interval narrowing via the same masked binary
         search the learned backend uses for its last-mile

Queries therefore share the whole SMEM machinery (ops/sa_search.py,
seeding/engine.py) with `root="kmer"`; only the initial window differs. The
table is rebuilt from the keys at load time in O(n) (one bincount+cumsum),
mirroring the reference's runtime-index-build philosophy
(src/fastmap.cpp:477-617) instead of its tens-of-GB on-disk trees.
"""

from __future__ import annotations

import os

import numpy as np

# ---- reference `.kmer_table` on-disk format (src/ertindex.cpp:823-914) ----
# A headerless array of numKmers = 4^15 little-endian uint64 entries, one per
# 15-mer. The 15-mer id is LITTLE-endian in base order (kmertoquery,
# src/ertindex.cpp:39-47): base j of the k-mer occupies bits [2j, 2j+2).
# Entry layout (composed at src/ertindex.cpp:833-839 and :730-752):
#     offset<<24 | ptr_width<<22 | num_hits<<17 | (lep & 0x3FFF)<<2 | type
#   offset    byte offset of the k-mer's radix tree in `.mlt_table`
#   ptr_width child-pointer byte width (2/3; 4 is stored as 0)
#   num_hits  the k-mer's hit count when < 20, else 0 (src/ertindex.cpp:730)
#   lep       leaf-end-pointer bits: bit j set iff the hit count changes when
#             the prefix grows from j+1 to j+2 bases, computed left-to-right
#             until the count reaches 0 (src/ertindex.cpp:535-565)
#   type      INVALID / SINGLE_HIT_LEAF / INFREQUENT / FREQUENT
#             (hit count 0 / 1 / 2..256 / >256, macro.h:196-200)
REF_KMER_K = 15          # kmerSize, src/macro.h:184
REF_NUM_KMERS = 1 << 30  # numKmers, src/macro.h:185
KMER_INVALID, KMER_SINGLE_HIT, KMER_INFREQUENT, KMER_FREQUENT = 0, 1, 2, 3
_HIT_THRESHOLD = 256     # INFREQUENT/FREQUENT split, src/macro.h:200


def pick_ert_bits(n_sa: int) -> int:
    """Root k-mer size (bases): aim for ~4 keys/slot like the reference's
    4^15 table over the 6G-suffix human genome (src/macro.h:184-186)."""
    k = int(np.ceil(np.log2(max(n_sa, 4)) / 2)) - 1
    return int(np.clip(k, 2, 15))


def build_kmer_table(key_hi: np.ndarray, bits: int) -> np.ndarray:
    """Prefix boundaries: table[m] = first key index whose top `bits` bases
    equal-or-exceed m; table[4^bits] = n. key_hi must be the sorted uint32
    plane of the first 16 suffix bases (bits <= 16)."""
    assert bits <= 16
    shift = np.uint32(32 - 2 * bits)
    ids = (key_hi >> shift).astype(np.int64)
    counts = np.bincount(ids, minlength=1 << (2 * bits))
    table = np.zeros((1 << (2 * bits)) + 1, dtype=np.int64)
    np.cumsum(counts, out=table[1:])
    return table.astype(np.int32)


# ---------------- reference `.kmer_table` interchange ----------------------
#
# Full `.mlt_table` radix-tree import is designed out: the trees serialize
# byte-wise pointer-chasing walks (src/ertseeding.cpp:2935-3435) whose every
# answer — "narrow this k-mer's hit set by one base / list its hits" — our
# sorted key planes already give as a contiguous-interval query, in the
# vectorized form the TPU needs. (Building a reference ERT index to walk is
# also off the table on this host: the builder runs 4^15 BWT extensions,
# hours at the reference's 32 threads, src/ertindex.cpp:781-935.) What IS
# interchanged is the 8 GiB root `.kmer_table`: we decode/encode the exact
# entry layout, derive every entry's class/hit-count/LEP from our planes,
# and cross-validate a reference-built table against them at `mem` time.


def ref_kmer_id_from_be(be: np.ndarray, k: int = REF_KMER_K) -> np.ndarray:
    """Map big-endian k-mer codes (first base in the TOP bits, the order of
    the sorted key plane) to reference table ids (first base in the BOTTOM
    bits, kmertoquery src/ertindex.cpp:39-47)."""
    be = np.asarray(be, np.int64)
    out = np.zeros_like(be)
    for j in range(k):
        out |= ((be >> np.int64(2 * (k - 1 - j))) & 3) << np.int64(2 * j)
    return out


def decode_kmer_entries(entries: np.ndarray):
    """Split raw uint64 entries into (type, lep, hits, ptr_width, offset)."""
    e = np.asarray(entries, np.uint64)
    typ = (e & np.uint64(3)).astype(np.uint8)
    lep = ((e >> np.uint64(2)) & np.uint64(0x3FFF)).astype(np.uint16)
    hits = ((e >> np.uint64(17)) & np.uint64(0x1F)).astype(np.uint8)
    ptrw = ((e >> np.uint64(22)) & np.uint64(3)).astype(np.uint8)
    off = (e >> np.uint64(24)).astype(np.int64)
    return typ, lep, hits, ptrw, off


def encode_kmer_entries(typ, lep, hits, ptr_width=None, offset=None):
    e = (np.asarray(typ, np.uint64)
         | (np.asarray(lep, np.uint64) & np.uint64(0x3FFF)) << np.uint64(2)
         | (np.asarray(hits, np.uint64) & np.uint64(0x1F)) << np.uint64(17))
    if ptr_width is not None:
        e |= (np.asarray(ptr_width, np.uint64) & np.uint64(3)) << np.uint64(22)
    if offset is not None:
        e |= np.asarray(offset, np.uint64) << np.uint64(24)
    return e


def _prefix_counts(key_hi: np.ndarray, be: np.ndarray, depth: int,
                   k: int = REF_KMER_K) -> np.ndarray:
    """Hit count of each k-mer's first `depth` bases: the width of the
    prefix's contiguous interval in the sorted key plane."""
    n = len(key_hi)
    pref = np.asarray(be, np.int64) >> np.int64(2 * (k - depth))
    lo_v = (pref << np.int64(32 - 2 * depth))
    hi_v = ((pref + 1) << np.int64(32 - 2 * depth))
    lo = np.searchsorted(key_hi, lo_v.astype(np.uint32), side="left")
    hi = np.where(hi_v >> np.int64(32),  # pref+1 == 4^depth: end of plane
                  np.int64(n),
                  np.searchsorted(key_hi,
                                  (hi_v & np.int64(0xFFFFFFFF)).astype(
                                      np.uint32), side="left"))
    return (hi - lo).astype(np.int64)


def kmer_classes_from_planes(key_hi: np.ndarray, be: np.ndarray,
                             k: int = REF_KMER_K):
    """(type, lep, hits) for big-endian k-mer codes `be`, with the
    reference builder's exact semantics (src/ertindex.cpp:535-573): LEP bit
    j records a hit-count change growing the prefix from j+1 to j+2 bases,
    scanning left-to-right and stopping once the count hits 0; `hits` is
    the full k-mer count, published in the entry only when < 20
    (src/ertindex.cpp:730-735)."""
    be = np.asarray(be, np.int64)
    cnt = _prefix_counts(key_hi, be, 1, k)
    lep = np.zeros(len(be), np.uint16)
    alive = cnt > 0
    for d in range(2, k + 1):
        nxt = _prefix_counts(key_hi, be, d, k)
        chg = alive & (nxt != cnt)
        lep |= np.where(chg, np.uint16(1 << (d - 2)), np.uint16(0))
        alive &= nxt > 0
        cnt = np.where(alive, nxt, cnt)  # prevHits advances only while alive
    hits_full = np.where(alive, cnt, 0)
    typ = np.full(len(be), KMER_INVALID, np.uint8)
    typ[hits_full == 1] = KMER_SINGLE_HIT
    typ[(hits_full > 1) & (hits_full <= _HIT_THRESHOLD)] = KMER_INFREQUENT
    typ[hits_full > _HIT_THRESHOLD] = KMER_FREQUENT
    hits_field = np.where(hits_full < 20, hits_full, 0).astype(np.uint8)
    return typ, lep, hits_field, hits_full


def write_kmer_table(key_hi: np.ndarray, path: str) -> int:
    """Export the index's 15-mer root in the reference's `.kmer_table`
    layout (sparse: only k-mers PRESENT in the text get an entry; absent
    slots are zero = INVALID with empty LEP, where the reference stores the
    partial LEP of the failed walk — consumers branch on type first). Tree
    offsets/ptr widths are zero: `.mlt_table` is designed out (see module
    header). Returns the number of non-zero entries."""
    n = len(key_hi)
    shift = np.uint32(32 - 2 * REF_KMER_K)
    be_all = (key_hi >> shift).astype(np.int64)
    be = np.unique(be_all)
    typ, lep, hits, _full = kmer_classes_from_planes(key_hi, be)
    entries = encode_kmer_entries(typ, lep, hits)
    mm = np.memmap(path, dtype="<u8", mode="w+", shape=(REF_NUM_KMERS,))
    mm[ref_kmer_id_from_be(be)] = entries
    mm.flush()
    del mm
    return int((entries != 0).sum())


def load_kmer_table(path: str) -> np.ndarray:
    """Memory-map a reference `.kmer_table` (headerless uint64[4^15])."""
    size = os.path.getsize(path)
    want = REF_NUM_KMERS * 8
    if size != want:
        raise ValueError(f"{path}: {size} bytes, expected {want} "
                         f"(uint64[4^{REF_KMER_K}])")
    return np.memmap(path, dtype="<u8", mode="r", shape=(REF_NUM_KMERS,))


def validate_reference_kmer_table(key_hi: np.ndarray, table: np.ndarray,
                                  sample: int = 65536,
                                  rng=None, max_mismatch: int = 32) -> dict:
    """Cross-check a reference-built `.kmer_table` against this index's key
    plane: sampled PRESENT k-mers must agree on type, published hit count
    and LEP; sampled uniform-random k-mers must agree on type. A small
    mismatch allowance covers the ≤14 text-tail suffixes the BWT drops but
    the T-padded key plane keeps. Raises on disagreement past that."""
    rng = rng or np.random.default_rng(0)
    shift = np.uint32(32 - 2 * REF_KMER_K)
    present_be = np.unique(
        (key_hi[rng.integers(0, len(key_hi), sample)] >> shift)
        .astype(np.int64))
    uniform = rng.integers(0, REF_NUM_KMERS, sample, dtype=np.int64)
    stats = {"present_checked": len(present_be), "uniform_checked": sample,
             "mismatches": 0}
    # present k-mers: full entry semantics
    got = np.asarray(table[ref_kmer_id_from_be(present_be)])
    g_typ, g_lep, g_hits, _, _ = decode_kmer_entries(got)
    w_typ, w_lep, w_hits, _full = kmer_classes_from_planes(key_hi, present_be)
    bad = (g_typ != w_typ) | (g_lep != w_lep) | (g_hits != w_hits)
    # uniform ids (mostly absent): type only — our sparse export zeroes the
    # partial LEP of absent k-mers (write_kmer_table docstring)
    be_u = np.zeros(sample, np.int64)
    for j in range(REF_KMER_K):
        be_u |= ((uniform >> np.int64(2 * j)) & 3) << np.int64(
            2 * (REF_KMER_K - 1 - j))
    gu_typ = decode_kmer_entries(np.asarray(table[uniform]))[0]
    wu_typ = kmer_classes_from_planes(key_hi, be_u)[0]
    stats["mismatches"] = int(bad.sum()) + int((gu_typ != wu_typ).sum())
    if stats["mismatches"] > max_mismatch:
        ex = present_be[bad][:4] if bad.any() else uniform[gu_typ != wu_typ][:4]
        raise ValueError(
            f"reference .kmer_table disagrees with this index on "
            f"{stats['mismatches']} of {len(present_be) + sample} sampled "
            f"k-mers (e.g. ids {ex.tolist()}) — wrong reference/index pair?")
    return stats
