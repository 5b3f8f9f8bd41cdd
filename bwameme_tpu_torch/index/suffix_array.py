"""Suffix-array construction.

Primary path: the native C++ SA-IS implementation in native/sais.cpp
(compiled on first use by ops/build.host_library into the port's build
directory, loaded via ctypes) — the TPU-build analog of the
reference's vendored saisxx (reference: src/sais.h, src/Learnedindex.cpp:242).
Fallback: an O(n log^2 n) numpy prefix-doubling builder (used when no C++
toolchain is present; fine for tests and small references).

Both produce the suffix array of the plain string with end-of-string treated
as the unique minimal sentinel (saisxx semantics).
"""

from __future__ import annotations

import ctypes

import numpy as np

from bwameme_tpu_torch.ops import build

_lib = None
_native_failed = False


def _load_native():
    global _lib, _native_failed
    if _lib is not None or _native_failed:
        return _lib
    try:
        lib = ctypes.CDLL(build.host_library(
            "sais", ("-O3", "-march=native", "-pthread")))
        lib.sais_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.sais_u8.restype = ctypes.c_int
        _lib = lib
    except Exception:
        _native_failed = True
        _lib = None
    return _lib


def build_suffix_array_native(text: np.ndarray) -> np.ndarray | None:
    lib = _load_native()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.uint8)
    sa = np.empty(len(text), dtype=np.int64)
    rc = lib.sais_u8(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(text),
    )
    if rc != 0:
        raise RuntimeError(f"sais_u8 failed with code {rc}")
    return sa


def build_suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array (numpy). End-of-string < any symbol."""
    n = len(text)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = text.astype(np.int64) + 1  # 0 reserved for "past the end"
    sa = np.argsort(rank, kind="stable")
    rank = rank.copy()
    k = 1
    idx = np.arange(n, dtype=np.int64)
    while True:
        # sort by (rank[i], rank[i+k] or 0)
        second = np.zeros(n, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        sa = order
        # re-rank
        r_prev = rank[order]
        s_prev = second[order]
        new_rank = np.empty(n, dtype=np.int64)
        changed = np.ones(n, dtype=bool)
        changed[1:] = (r_prev[1:] != r_prev[:-1]) | (s_prev[1:] != s_prev[:-1])
        new_rank[order] = np.cumsum(changed)
        rank = new_rank
        if rank[sa[-1]] == n:
            break
        k <<= 1
        if k >= n:
            break
    return sa.astype(np.int64)


def build_suffix_array(text: np.ndarray, prefer_native: bool = True) -> np.ndarray:
    """Suffix array of a 0..3 (or general uint8) text."""
    if prefer_native:
        sa = build_suffix_array_native(text)
        if sa is not None:
            return sa
    return build_suffix_array_doubling(text)
