"""Interchange with the reference's on-disk index formats (SURVEY.md §2.3).

Lets indexes built by BWA-MEME (`bwa-meme index -a meme`) be imported, and
ours exported for byte-level cross-checks:

* ``.0123``               byte-per-base 0/1/2/3 of text+RC (+T-pad is NOT
                          included in the file; reference writes only
                          pac_len = 2*l_pac bytes, src/Learnedindex.cpp:223)
* ``.pos_packed``         5 bytes/entry: 40-bit SA position
                          (src/Learnedindex.cpp:265-274)
* ``.suffixarray_uint64`` u64 count header, then one u64 32-base 2-bit key
                          per SA entry (src/Learnedindex.cpp:250-263)
* ``.possa_packed``       13 bytes/entry: 5-byte pos + 8-byte key (MODE>=2
                          runtime layout, src/Learnedindex.cpp:322-325)
* ``.ref2sa_packed``      5 bytes/refpos inverse SA (MODE3,
                          src/Learnedindex.cpp:311-315)
"""

from __future__ import annotations

import numpy as np


def write_0123(idx, prefix: str) -> None:
    with open(prefix + ".0123", "wb") as f:
        idx.text[: 2 * idx.l_pac].astype(np.int8).tofile(f)


def read_0123(prefix: str) -> np.ndarray:
    return np.fromfile(prefix + ".0123", dtype=np.uint8)


def _pack5(values: np.ndarray) -> np.ndarray:
    """40-bit little-layout pack: u32 of (v>>8) followed by low byte —
    matching  *(uint32*)p = pos>>8 ; p[4] = pos&0xff  on little-endian
    (reference: src/Learnedindex.cpp:268-273 write order)."""
    v = values.astype(np.uint64)
    out = np.empty((len(v), 5), dtype=np.uint8)
    hi = (v >> np.uint64(8)).astype(np.uint32)
    out[:, 0] = hi & 0xFF
    out[:, 1] = (hi >> 8) & 0xFF
    out[:, 2] = (hi >> 16) & 0xFF
    out[:, 3] = (hi >> 24) & 0xFF
    out[:, 4] = (v & np.uint64(0xFF)).astype(np.uint8)
    return out.reshape(-1)


def _unpack5(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 5).astype(np.uint64)
    hi = b[:, 0] | (b[:, 1] << np.uint64(8)) | (b[:, 2] << np.uint64(16)) | (b[:, 3] << np.uint64(24))
    return ((hi << np.uint64(8)) | b[:, 4]).astype(np.int64)


def write_pos_packed(idx, prefix: str) -> None:
    with open(prefix + ".pos_packed", "wb") as f:
        _pack5(idx.sa).tofile(f)


def read_pos_packed(prefix: str) -> np.ndarray:
    return _unpack5(np.fromfile(prefix + ".pos_packed", dtype=np.uint8))


def write_suffixarray_uint64(idx, prefix: str) -> None:
    keys = (idx.key_hi.astype(np.uint64) << np.uint64(32)) | idx.key_lo.astype(np.uint64)
    with open(prefix + ".suffixarray_uint64", "wb") as f:
        np.uint64(len(keys)).tofile(f)
        keys.tofile(f)


def read_suffixarray_uint64(prefix: str) -> np.ndarray:
    with open(prefix + ".suffixarray_uint64", "rb") as f:
        n = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
        return np.fromfile(f, dtype=np.uint64, count=n)


def write_possa_packed(idx, prefix: str) -> None:
    keys = (idx.key_hi.astype(np.uint64) << np.uint64(32)) | idx.key_lo.astype(np.uint64)
    pos5 = _pack5(idx.sa).reshape(-1, 5)
    out = np.empty((len(keys), 13), dtype=np.uint8)
    out[:, :5] = pos5
    out[:, 5:] = keys.view(np.uint8).reshape(-1, 8)  # little-endian key bytes
    with open(prefix + ".possa_packed", "wb") as f:
        out.tofile(f)


def write_ref2sa_packed(idx, prefix: str) -> None:
    assert idx.isa is not None
    with open(prefix + ".ref2sa_packed", "wb") as f:
        _pack5(idx.isa).tofile(f)


def export_reference_formats(idx, prefix: str, full: bool = False) -> None:
    """Write the reference-compatible index files next to `prefix`,
    including the P-RMI ``_L{0,1,2}_PARAMETERS`` (so the reference
    binary's `mem -7` path runs on our index with no Rust trainer)."""
    from bwameme_tpu_torch.models.prmi import write_rmi_parameters

    write_0123(idx, prefix)
    write_pos_packed(idx, prefix)
    write_suffixarray_uint64(idx, prefix)
    write_rmi_parameters(idx, prefix)
    if full:
        write_possa_packed(idx, prefix)
        if idx.isa is not None:
            write_ref2sa_packed(idx, prefix)


def import_reference_index(prefix: str, train_bits: int | None = None):
    """Build a MemeIndex from reference-produced files
    (.pac/.ann/.amb + .0123 + .pos_packed [+ .suffixarray_uint64]).

    When the reference's trained ``_L{1,2}_PARAMETERS`` model files are
    present, the trained P-RMI is imported directly (apply_rmi_parameters
    — no retrain); otherwise the P-RMI is trained fresh in JAX/numpy
    (replacing the Rust trainer)."""
    import os

    from bwameme_tpu_torch.index import bntseq as bnsmod
    from bwameme_tpu_torch.index.build import MemeIndex, build_text
    from bwameme_tpu_torch.index.packing import extract_key64, pack_words
    from bwameme_tpu_torch.models.prmi import (apply_rmi_parameters,
                                         read_rmi_parameters, train_prmi)

    bns = bnsmod.restore(prefix)
    text, pad = build_text(bns.code)
    # cross-check the .0123 body if present
    sa = read_pos_packed(prefix)
    keys = extract_key64(text, sa, pad_code=3)
    key_hi = (keys >> np.uint64(32)).astype(np.uint32)
    key_lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    isa = np.empty(len(sa), dtype=np.int64)
    isa[sa] = np.arange(len(sa), dtype=np.int64)
    text32 = np.concatenate([
        pack_words(text, pad_code=3),
        np.full(12, 0xFFFFFFFF, dtype=np.uint32),
    ])
    idx = MemeIndex(bns=bns, text=text, text32=text32, sa=sa,
                    key_hi=key_hi, key_lo=key_lo, isa=isa, pad_len=pad)
    if os.path.exists(prefix + ".suffixarray_uint64_L2_PARAMETERS"):
        apply_rmi_parameters(idx, read_rmi_parameters(prefix))
        return idx
    if train_bits is None:
        train_bits = max(8, min(28, int(np.ceil(np.log2(max(len(sa), 2)))) - 3))
    train_prmi(idx, train_bits)
    return idx
