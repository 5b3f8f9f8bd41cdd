"""2-bit DNA packing utilities (numpy, host side).

Two packed layouts are used throughout:

* **pac layout** (file format compat): base ``i`` occupies bits
  ``(3 - i%4)*2`` of byte ``i//4`` — i.e. MSB-first within a byte. This is the
  classic bwa ``.pac`` layout (reference: src/bntseq.h _set_pac/_get_pac).

* **word layout** (device compute): base ``i`` occupies bits
  ``(15 - i%16)*2`` of uint32 word ``i//16`` — MSB-first within a 32-bit word,
  so that unsigned comparison of words is lexicographic comparison of the
  16 bases they hold. This is what the seeding kernels gather from HBM; it is
  the TPU-native analog of the reference's byte-shifted read buffers
  (reference: src/bwamem.cpp:1264-1344) and of the 8-byte suffix compares in
  compare_read_and_ref_binary (reference: src/LearnedIndex_seeding.cpp:226-519).
"""

from __future__ import annotations

import numpy as np

# ASCII -> 4-bit code table: A/a=0 C/c=1 G/g=2 T/t=3, everything else 4 (N).
# Semantics of nst_nt4_table (reference: src/bntseq.cpp).
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i

CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def seq_to_code(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes 0..4."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return NT4_TABLE[arr]


def code_to_seq(code: np.ndarray) -> str:
    return CODE_TO_BASE[np.minimum(code, 4)].tobytes().decode()


def pack_pac(code: np.ndarray) -> np.ndarray:
    """Pack 0..3 codes into the bwa .pac byte layout (4 bases/byte, MSB first)."""
    n = len(code)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = code
    b = padded.reshape(-1, 4)
    return (
        (b[:, 0] << 6) | (b[:, 1] << 4) | (b[:, 2] << 2) | b[:, 3]
    ).astype(np.uint8)


def unpack_pac(pac: np.ndarray, n_bases: int) -> np.ndarray:
    """Inverse of pack_pac."""
    b = pac[: (n_bases + 3) // 4]
    out = np.empty((len(b), 4), dtype=np.uint8)
    out[:, 0] = b >> 6
    out[:, 1] = (b >> 4) & 3
    out[:, 2] = (b >> 2) & 3
    out[:, 3] = b & 3
    return out.reshape(-1)[:n_bases]


def pack_words(code: np.ndarray, pad_code: int = 3) -> np.ndarray:
    """Pack 0..3 codes into uint32 words, 16 bases/word, MSB-first.

    Tail bases are padded with ``pad_code`` (default T=3, matching the PAD_1
    sentinel convention of the reference key builder, src/Learnedindex.cpp).
    """
    n = len(code)
    n_words = (n + 15) // 16
    padded = np.full(n_words * 16, pad_code, dtype=np.uint32)
    padded[:n] = code
    b = padded.reshape(-1, 16).astype(np.uint32)
    out = np.zeros(n_words, dtype=np.uint32)
    for i in range(16):
        out |= b[:, i] << np.uint32(2 * (15 - i))
    return out


def unpack_words(words: np.ndarray, n_bases: int) -> np.ndarray:
    out = np.empty((len(words), 16), dtype=np.uint8)
    for i in range(16):
        out[:, i] = (words >> np.uint32(2 * (15 - i))) & np.uint32(3)
    return out.reshape(-1)[:n_bases]


def extract_key64(code: np.ndarray, pos: np.ndarray, pad_code: int = 3) -> np.ndarray:
    """32-base 2-bit key (uint64, MSB-first) starting at each position.

    Positions beyond the end of ``code`` are padded with ``pad_code``. This is
    the host-side analog of Tokenization (reference:
    src/LearnedIndex_seeding.cpp:613-795) and of the key regeneration in
    get_key_of_ref (reference: src/fastmap.cpp:537-612).
    """
    pos = np.asarray(pos, dtype=np.int64)
    # pack once, then gather 3 words per position and funnel-shift — ~6 ops
    # per key instead of 32 gather+shift rounds
    words = np.concatenate([
        pack_words(code, pad_code=pad_code),
        np.full(3, _word_fill(pad_code), dtype=np.uint32),
    ])
    # the one-pass C++ kernel (~100x on the throttled build hosts, where
    # each numpy gather pass over 10^8+ entries costs minutes)
    from bwameme_tpu_torch.align.native import extract_key64_native

    out = extract_key64_native(words, pos)
    if out is not None:
        return out
    wi = pos >> 4
    sh = ((pos & 15) << 1).astype(np.uint32)
    w0 = words[wi].astype(np.uint64)
    w1 = words[wi + 1].astype(np.uint64)
    w2 = words[wi + 2].astype(np.uint64)
    # key = bits [sh, sh+64) of the 96-bit window w0:w1:w2
    hi64 = (w0 << np.uint64(32)) | w1
    shifted = hi64 << sh.astype(np.uint64)
    low = np.where(sh == 0, np.uint64(0),
                   w2 >> (np.uint64(32) - sh.astype(np.uint64)))
    return shifted | low


def _word_fill(pad_code: int) -> np.uint32:
    """uint32 word of 16 repeated 2-bit pad codes."""
    w = 0
    for _ in range(16):
        w = (w << 2) | (pad_code & 3)
    return np.uint32(w)
