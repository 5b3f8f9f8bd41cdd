"""ctypes bindings for the native host alignment kernels
(native/hostkernels.cpp, built by ops/build.host_library into the port's own
build directory). Falls back to the Python reference implementations in
align/sw_scalar.py when no C++ toolchain is available."""

from __future__ import annotations

import ctypes

import numpy as np

from bwameme_tpu_torch.ops import build

# -ffp-contract=off: the P-RMI trainer's f32 residual pass must round
# multiply and add separately, exactly like the numpy reference (fma
# contraction would shift predictions ~1 ulp)
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-pthread")

_lib = None
_failed = False


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        lib = ctypes.CDLL(build.host_library("hostkernels", GXX_FLAGS))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i8p = ctypes.POINTER(ctypes.c_int8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.sw_global_c.argtypes = [
            u8p, ctypes.c_int32, u8p, ctypes.c_int32, i8p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, u32p, ctypes.c_int32, i32p,
        ]
        lib.sw_global_c.restype = ctypes.c_int32
        lib.sw_extend_c.argtypes = [
            u8p, ctypes.c_int32, u8p, ctypes.c_int32, i8p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p,
        ]
        lib.sw_extend_c.restype = None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.chain_and_filter_c.argtypes = [
            ctypes.c_int32, i32p,                       # R, l_query
            i32p, i32p, i32p, i64p, i64p,               # smem off/start/end/salo/cnt
            i64p,                                       # sa
            ctypes.c_int64, ctypes.c_int32, i64p, u8p,  # l_pac, n_ctg, off, alt
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # max_occ, w, gap
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # minseed, mincw, maxext
            ctypes.c_double, ctypes.c_double,           # mask_level, drop_ratio
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # a, o_del, e_del
            ctypes.c_int32, ctypes.c_int32,             # o_ins, e_ins
            ctypes.c_int64, ctypes.c_int64,             # chain_cap, seed_cap
            i64p,                                       # chain_off
            i64p, i32p, u8p, i32p, i32p, f64p,          # chain fields
            i64p,                                       # seed_off
            i64p, i32p, i32p,                           # seed fields
        ]
        lib.chain_and_filter_c.restype = ctypes.c_int64
        lib.extend_prepare_c.argtypes = [
            ctypes.c_int32, i32p,                       # R, l_query
            i64p, i32p, f64p,                           # chain off/rid/frep
            i64p, i64p, i32p, i32p,                     # seed off/rbeg/qbeg/len
            ctypes.c_int64, ctypes.c_int32, i64p,       # l_pac, n_ctg, off
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # a, o_del, e_del
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # o_ins, e_ins, w
            i32p, i32p, i64p, i32p, i64p,               # read qb rb qe re
            i32p, i32p, i32p, i32p, i32p, f64p,         # sc tsc w sl0 rid frep
            i32p, i32p, i32p,                           # h0seed seedcov chain
            i32p, i32p, i32p, i64p, i32p, i64p,         # left jobs + n
            i32p, i32p, i32p, i32p, i64p, i32p, i64p,   # right jobs + n
        ]
        lib.extend_prepare_c.restype = ctypes.c_int64
        lib.extend_finalize_c.argtypes = [
            ctypes.c_int32, i32p, i32p, i32p,           # R lq read_off reg_read
            i64p, i64p, i64p, i32p, i32p,               # chain/seed arrays
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # a o_del e_del
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # o_ins e_ins w
            ctypes.c_int32, ctypes.c_int32,             # pen_clip5 pen_clip3
            ctypes.c_int64, i32p, i64p, i32p, i64p,     # nregs qb rb qe re
            i32p, i32p, i32p, i32p, i32p, i32p, i32p,   # sc tsc w sl0 cov ch h0
            ctypes.c_int64, i32p, i32p, i32p, i32p, i32p, i32p, i32p,  # left
            ctypes.c_int64, i32p, i32p, i32p, i32p, i32p, i32p, i32p,  # right
        ]
        lib.extend_finalize_c.restype = None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.extract_key64_c.argtypes = [u32p, i64p, ctypes.c_int64, u64p]
        lib.extract_key64_c.restype = None
        lib.invert_sa_c.argtypes = [i64p, ctypes.c_int64, i64p]
        lib.invert_sa_c.restype = None
        lib.filter_lt_c.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                    i64p]
        lib.filter_lt_c.restype = ctypes.c_int64
        lib.longest_runs_c.argtypes = [u8p, ctypes.c_int64, i64p, i64p]
        lib.longest_runs_c.restype = None
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.train_prmi_c.argtypes = [u32p, u32p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int32,
                                     i64p, f32p, f32p, i32p, i32p]
        lib.train_prmi_c.restype = None
        _lib = lib
    except (OSError, RuntimeError, AttributeError) as e:
        from bwameme_tpu_torch.utils import fallbacks

        fallbacks.note("native.hostkernels_load", e)
        _failed = True
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def sw_global_native(query, target, mat, o_del, e_del, o_ins, e_ins, w):
    """Native ksw_global2; returns (score, [(op,len)...]) or None."""
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(np.minimum(query, 4), dtype=np.uint8)
    t = np.ascontiguousarray(np.minimum(target, 4), dtype=np.uint8)
    m = np.ascontiguousarray(mat, dtype=np.int8)
    cap = len(q) + len(t) + 4
    cig = np.empty(cap, dtype=np.uint32)
    n = ctypes.c_int32(0)
    score = lib.sw_global_c(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        o_del, e_del, o_ins, e_ins, w,
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap,
        ctypes.byref(n),
    )
    if score == -0x40000000:
        return None
    out = [(int(c & 0xF), int(c >> 4)) for c in cig[: n.value]]
    return int(score), out


def chain_and_filter_native(opt, bns, l_query, smem_off, smem_start, smem_end,
                            smem_salo, smem_cnt, sa, ctg_off, ctg_alt):
    """Batched chain_seeds + filter_chains (native). Returns flat arrays
    (chain_off, chain_pos, chain_rid, chain_is_alt, chain_w, chain_kept,
    chain_frac_rep, seed_off, seed_rbeg, seed_qbeg, seed_len) or None when
    the native library is unavailable (caller uses the Python path)."""
    lib = _load()
    if lib is None:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)

    def p32(x):
        return x.ctypes.data_as(i32p)

    def p64(x):
        return x.ctypes.data_as(i64p)

    R = len(l_query)
    # exact caps: every subsampled hit can become its own chain
    per = np.minimum(smem_cnt, opt.max_occ)
    cap = int(per.sum()) + 1
    chain_off = np.empty(R + 1, np.int64)
    chain_pos = np.empty(cap, np.int64)
    chain_rid = np.empty(cap, np.int32)
    chain_is_alt = np.empty(cap, np.uint8)
    chain_w = np.empty(cap, np.int32)
    chain_kept = np.empty(cap, np.int32)
    chain_frac_rep = np.empty(cap, np.float64)
    seed_off = np.empty(cap + 1, np.int64)
    seed_rbeg = np.empty(cap, np.int64)
    seed_qbeg = np.empty(cap, np.int32)
    seed_len = np.empty(cap, np.int32)
    n = lib.chain_and_filter_c(
        R, p32(l_query), p32(smem_off), p32(smem_start), p32(smem_end),
        p64(smem_salo), p64(smem_cnt), p64(sa),
        bns.l_pac, len(bns.contigs), p64(ctg_off),
        ctg_alt.ctypes.data_as(u8p),
        opt.max_occ, opt.w, opt.max_chain_gap, opt.min_seed_len,
        opt.min_chain_weight, min(opt.max_chain_extend, 1 << 30),
        opt.mask_level, opt.drop_ratio,
        opt.a, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        cap, cap,
        p64(chain_off), p64(chain_pos), p32(chain_rid),
        chain_is_alt.ctypes.data_as(u8p), p32(chain_w), p32(chain_kept),
        chain_frac_rep.ctypes.data_as(f64p),
        p64(seed_off), p64(seed_rbeg), p32(seed_qbeg), p32(seed_len),
    )
    if n < 0:
        return None
    return (chain_off, chain_pos, chain_rid, chain_is_alt, chain_w,
            chain_kept, chain_frac_rep, seed_off, seed_rbeg, seed_qbeg,
            seed_len, int(n))


def extend_prepare_native(opt, bns, lq, chain_off, chain_rid,
                          chain_frac_rep, seed_off, seed_rbeg, seed_qbeg,
                          seed_len, ctg_off):
    """Native reg-table + coordinate-job construction for the fused
    extension (contract: align/extend.py:fused_extend_submit's first loop).
    Returns a dict of arrays or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)

    def p32(x):
        return x.ctypes.data_as(i32p)

    def p64(x):
        return x.ctypes.data_as(i64p)

    R = len(lq)
    cap = max(int(seed_off[int(chain_off[R])]), 1)
    o = {
        "reg_read": np.empty(cap, np.int32),
        "reg_qb": np.empty(cap, np.int32),
        "reg_rb": np.empty(cap, np.int64),
        "reg_qe": np.empty(cap, np.int32),
        "reg_re": np.empty(cap, np.int64),
        "reg_score": np.empty(cap, np.int32),
        "reg_truesc": np.empty(cap, np.int32),
        "reg_w": np.empty(cap, np.int32),
        "reg_seedlen0": np.empty(cap, np.int32),
        "reg_rid": np.empty(cap, np.int32),
        "reg_frac_rep": np.empty(cap, np.float64),
        "reg_h0seed": np.empty(cap, np.int32),
        "reg_seedcov": np.empty(cap, np.int32),
        "reg_chain": np.empty(cap, np.int32),
        "l_reg": np.empty(cap, np.int32),
        "l_row": np.empty(cap, np.int32),
        "l_qlen": np.empty(cap, np.int32),
        "l_tstart": np.empty(cap, np.int64),
        "l_tlen": np.empty(cap, np.int32),
        "r_reg": np.empty(cap, np.int32),
        "r_row": np.empty(cap, np.int32),
        "r_qstart": np.empty(cap, np.int32),
        "r_qlen": np.empty(cap, np.int32),
        "r_tstart": np.empty(cap, np.int64),
        "r_tlen": np.empty(cap, np.int32),
    }
    nl = ctypes.c_int64(0)
    nr = ctypes.c_int64(0)
    n = lib.extend_prepare_c(
        R, p32(lq),
        p64(chain_off), p32(chain_rid),
        chain_frac_rep.ctypes.data_as(f64p),
        p64(seed_off), p64(seed_rbeg), p32(seed_qbeg), p32(seed_len),
        bns.l_pac, len(bns.contigs), p64(ctg_off),
        opt.a, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w,
        p32(o["reg_read"]), p32(o["reg_qb"]), p64(o["reg_rb"]),
        p32(o["reg_qe"]), p64(o["reg_re"]), p32(o["reg_score"]),
        p32(o["reg_truesc"]), p32(o["reg_w"]), p32(o["reg_seedlen0"]),
        p32(o["reg_rid"]), o["reg_frac_rep"].ctypes.data_as(f64p),
        p32(o["reg_h0seed"]), p32(o["reg_seedcov"]), p32(o["reg_chain"]),
        p32(o["l_reg"]), p32(o["l_row"]), p32(o["l_qlen"]),
        p64(o["l_tstart"]), p32(o["l_tlen"]), ctypes.byref(nl),
        p32(o["r_reg"]), p32(o["r_row"]), p32(o["r_qstart"]),
        p32(o["r_qlen"]), p64(o["r_tstart"]), p32(o["r_tlen"]),
        ctypes.byref(nr),
    )
    o["n_regs"] = int(n)
    o["n_left"] = int(nl.value)
    o["n_right"] = int(nr.value)
    return o


def extend_finalize_native(opt, lq, read_reg_off, prep, chain_off, seed_off,
                           seed_rbeg, seed_qbeg, seed_len, left, right):
    """Native fold + seedcov + contained-seed purge (contract:
    align/extend.py:fused_extend_finish). Mutates prep's reg arrays."""
    lib = _load()
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def p32(x):
        return x.ctypes.data_as(i32p)

    def p64(x):
        return x.ctypes.data_as(i64p)

    def c32(x):
        return np.ascontiguousarray(x, np.int32)

    nl, nr = prep["n_left"], prep["n_right"]
    l_arrs = [c32(left[k][:nl]) for k in
              ("score", "qle", "tle", "gtle", "gscore", "w_used")]
    r_arrs = [c32(right[k][:nr]) for k in
              ("score", "qle", "tle", "gtle", "gscore", "w_used")]
    lib.extend_finalize_c(
        len(lq), p32(lq), p32(read_reg_off), p32(prep["reg_read"]),
        p64(chain_off), p64(seed_off), p64(seed_rbeg), p32(seed_qbeg),
        p32(seed_len),
        opt.a, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w,
        opt.pen_clip5, opt.pen_clip3,
        prep["n_regs"], p32(prep["reg_qb"]), p64(prep["reg_rb"]),
        p32(prep["reg_qe"]), p64(prep["reg_re"]), p32(prep["reg_score"]),
        p32(prep["reg_truesc"]), p32(prep["reg_w"]),
        p32(prep["reg_seedlen0"]), p32(prep["reg_seedcov"]),
        p32(prep["reg_chain"]), p32(prep["reg_h0seed"]),
        nl, p32(prep["l_reg"]), p32(l_arrs[0]), p32(l_arrs[1]),
        p32(l_arrs[2]), p32(l_arrs[3]), p32(l_arrs[4]), p32(l_arrs[5]),
        nr, p32(prep["r_reg"]), p32(r_arrs[0]), p32(r_arrs[1]),
        p32(r_arrs[2]), p32(r_arrs[3]), p32(r_arrs[4]), p32(r_arrs[5]),
    )


def sw_extend_native(query, target, mat, o_del, e_del, o_ins, e_ins, w,
                     end_bonus, zdrop, h0):
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(np.minimum(query, 4), dtype=np.uint8)
    t = np.ascontiguousarray(np.minimum(target, 4), dtype=np.uint8)
    m = np.ascontiguousarray(mat, dtype=np.int8)
    out = np.empty(6, dtype=np.int32)
    lib.sw_extend_c(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop, h0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def _p(arr, ct):
    return arr.ctypes.data_as(ctypes.POINTER(ct))


def extract_key64_native(words, pos):
    """One-pass C++ key extraction (see hostkernels.cpp); None w/o lib."""
    lib = _load()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    out = np.empty(len(pos), dtype=np.uint64)
    lib.extract_key64_c(_p(words, ctypes.c_uint32), _p(pos, ctypes.c_int64),
                        len(pos), _p(out, ctypes.c_uint64))
    return out


def invert_sa_native(sa):
    lib = _load()
    if lib is None:
        return None
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    out = np.empty(len(sa), dtype=np.int64)
    lib.invert_sa_c(_p(sa, ctypes.c_int64), len(sa),
                    _p(out, ctypes.c_int64))
    return out


def longest_runs_native(x):
    """(longest A run, longest T run) in one pass; None w/o lib."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.uint8)
    a = ctypes.c_int64(0)
    t = ctypes.c_int64(0)
    lib.longest_runs_c(_p(x, ctypes.c_uint8), len(x), ctypes.byref(a),
                       ctypes.byref(t))
    return int(a.value), int(t.value)


def filter_lt_native(sa, limit):
    lib = _load()
    if lib is None:
        return None
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    out = np.empty(len(sa), dtype=np.int64)
    k = lib.filter_lt_c(_p(sa, ctypes.c_int64), len(sa), int(limit),
                        _p(out, ctypes.c_int64))
    return out[:k].copy()


def train_prmi_native(key_hi, key_lo, bits, margin):
    """Two-pass C++ P-RMI trainer (see hostkernels.cpp); returns
    (leaf_start i64[L+1], alpha f32[L], beta f32[L], err_lo i32[L],
    err_hi i32[L]) or None without the lib."""
    lib = _load()
    if lib is None:
        return None
    key_hi = np.ascontiguousarray(key_hi, dtype=np.uint32)
    key_lo = np.ascontiguousarray(key_lo, dtype=np.uint32)
    L = 1 << bits
    leaf_start = np.empty(L + 1, dtype=np.int64)
    alpha = np.empty(L, dtype=np.float32)
    beta = np.empty(L, dtype=np.float32)
    err_lo = np.empty(L, dtype=np.int32)
    err_hi = np.empty(L, dtype=np.int32)
    lib.train_prmi_c(_p(key_hi, ctypes.c_uint32), _p(key_lo, ctypes.c_uint32),
                     len(key_hi), int(bits), int(margin),
                     _p(leaf_start, ctypes.c_int64),
                     _p(alpha, ctypes.c_float), _p(beta, ctypes.c_float),
                     _p(err_lo, ctypes.c_int32), _p(err_hi, ctypes.c_int32))
    return leaf_start, alpha, beta, err_lo, err_hi


def _fin_blobs(bns):
    """Cached flat contig table for finalize_se_c."""
    b = getattr(bns, "_fin_blobs", None)
    if b is None:
        names = b"".join(c.name.encode() for c in bns.contigs)
        name_off = np.zeros(len(bns.contigs) + 1, np.int64)
        np.cumsum([len(c.name.encode()) for c in bns.contigs],
                  out=name_off[1:])
        off = np.asarray([c.offset for c in bns.contigs], np.int64)
        is_alt = np.asarray(
            [1 if getattr(c, "is_alt", False) else 0 for c in bns.contigs],
            np.uint8)
        b = (names, name_off, off, is_alt)
        bns._fin_blobs = b
    return b


def finalize_se_native(opt, bns, text, recs, regs_per_read, rg_id,
                       n_processed):
    """Whole-batch single-end finalization in C++ (finalize_se_c):
    sort_dedup_patch + mark_primary + XA + reg2aln + aln2sam for every
    read, returning finished SAM blocks (byte-identical to the Python
    contract in align/finalize.py — differentially tested). None when the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    R = len(recs)
    f = _flatten_finalize_inputs(recs, regs_per_read)
    ctg_names, ctg_name_off, ctg_off, ctg_is_alt = _fin_blobs(bns)
    text = np.ascontiguousarray(text, dtype=np.uint8)
    mat = np.ascontiguousarray(opt.mat, dtype=np.int8)
    iopt, dopt = _fin_opts(opt, 0, int(n_processed))
    rg = (rg_id or "").encode()

    if not getattr(lib, "_fin_sig", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i8p = ctypes.POINTER(ctypes.c_int8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.finalize_se_c.argtypes = [
            ctypes.c_int32, i32p, i64p, i64p, i32p, i32p, i32p, i32p, i32p,
            i32p, i32p, i32p, i32p, f64p, u8p, u8p, i64p,
            ctypes.c_char_p, i64p, ctypes.c_char_p, i64p, ctypes.c_char_p,
            i64p, u8p, ctypes.c_int64, ctypes.c_int32, i64p,
            ctypes.c_char_p, i64p, u8p, i8p, i64p, f64p,
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64, i64p,
        ]
        lib.finalize_se_c.restype = ctypes.c_int64
        lib._fin_sig = True

    cap = int(sum((len(rec.codes) * 2 + 300) * (len(regs) + 1)
                  for rec, regs in zip(recs, regs_per_read)) + 4096)
    out_off = np.zeros(R + 1, np.int64)
    for _ in range(2):
        buf = ctypes.create_string_buffer(cap)
        total = lib.finalize_se_c(
            R, _p(f["reg_off"], ctypes.c_int32),
            _p(f["rb"], ctypes.c_int64), _p(f["re"], ctypes.c_int64),
            _p(f["qb"], ctypes.c_int32), _p(f["qe"], ctypes.c_int32),
            _p(f["rid"], ctypes.c_int32), _p(f["score"], ctypes.c_int32),
            _p(f["truesc"], ctypes.c_int32), _p(f["sub"], ctypes.c_int32),
            _p(f["csub"], ctypes.c_int32), _p(f["w"], ctypes.c_int32),
            _p(f["seedcov"], ctypes.c_int32),
            _p(f["frac_rep"], ctypes.c_double),
            _p(f["is_alt"], ctypes.c_uint8),
            _p(f["qcodes"], ctypes.c_uint8), _p(f["qoff"], ctypes.c_int64),
            f["names"], _p(f["name_off"], ctypes.c_int64),
            f["quals"], _p(f["qual_off"], ctypes.c_int64),
            f["comms"], _p(f["comm_off"], ctypes.c_int64),
            _p(text, ctypes.c_uint8), int(bns.l_pac),
            len(bns.contigs), _p(ctg_off, ctypes.c_int64),
            ctg_names, _p(ctg_name_off, ctypes.c_int64),
            _p(ctg_is_alt, ctypes.c_uint8),
            _p(mat, ctypes.c_int8), _p(iopt, ctypes.c_int64),
            _p(dopt, ctypes.c_double),
            rg, len(rg), buf, cap, _p(out_off, ctypes.c_int64),
        )
        if total >= 0:
            raw = buf.raw[:total]
            return [raw[out_off[i]: out_off[i + 1]].decode()
                    for i in range(R)]
        cap = int(-total) + 1
    return None

def _flatten_finalize_inputs(recs, regs_per_read):
    """Shared flat-array construction for finalize_{se,pe}_c."""
    R = len(recs)
    G = sum(len(r) for r in regs_per_read)
    f = {}
    f["reg_off"] = np.zeros(R + 1, np.int32)
    np.cumsum([len(r) for r in regs_per_read], out=f["reg_off"][1:])
    for k, dt in (("rb", np.int64), ("re", np.int64), ("qb", np.int32),
                  ("qe", np.int32), ("rid", np.int32), ("score", np.int32),
                  ("truesc", np.int32), ("sub", np.int32),
                  ("csub", np.int32), ("w", np.int32),
                  ("seedcov", np.int32), ("frac_rep", np.float64),
                  ("is_alt", np.uint8)):
        f[k] = np.empty(G, dt)
    g = 0
    for regs in regs_per_read:
        for r in regs:
            f["rb"][g] = r.rb
            f["re"][g] = r.re
            f["qb"][g] = r.qb
            f["qe"][g] = r.qe
            f["rid"][g] = r.rid
            f["score"][g] = r.score
            f["truesc"][g] = r.truesc
            f["sub"][g] = r.sub
            f["csub"][g] = r.csub
            f["w"][g] = r.w
            f["seedcov"][g] = r.seedcov
            f["frac_rep"][g] = r.frac_rep
            f["is_alt"][g] = 1 if r.is_alt else 0
            g += 1
    f["qoff"] = np.zeros(R + 1, np.int64)
    np.cumsum([len(rec.codes) for rec in recs], out=f["qoff"][1:])
    f["qcodes"] = (np.concatenate([rec.codes for rec in recs]).astype(
        np.uint8) if R else np.zeros(0, np.uint8))
    f["names"] = b"".join(rec.name.encode() for rec in recs)
    f["name_off"] = np.zeros(R + 1, np.int64)
    np.cumsum([len(rec.name.encode()) for rec in recs],
              out=f["name_off"][1:])
    f["quals"] = b"".join((rec.qual or "").encode() for rec in recs)
    f["qual_off"] = np.zeros(R + 1, np.int64)
    np.cumsum([len((rec.qual or "").encode()) for rec in recs],
              out=f["qual_off"][1:])
    f["comms"] = b"".join((rec.comment or "").encode() for rec in recs)
    f["comm_off"] = np.zeros(R + 1, np.int64)
    np.cumsum([len((rec.comment or "").encode()) for rec in recs],
              out=f["comm_off"][1:])
    return f


def _fin_opts(opt, extra14, extra15):
    iopt = np.asarray([
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.a, opt.b, opt.T,
        opt.w, opt.max_chain_gap, opt.min_seed_len, opt.flag,
        opt.max_XA_hits, opt.max_XA_hits_alt, opt.mapQ_coef_fac, extra14,
        extra15,
    ], np.int64)
    dopt = np.asarray([
        opt.mask_level, opt.mask_level_redun, opt.drop_ratio,
        opt.XA_drop_ratio, opt.mapQ_coef_len,
    ], np.float64)
    return iopt, dopt


def finalize_pe_native(opt, bns, text, pes, pair_id0, recs, regs_per_read,
                       rg_id):
    """Whole-chunk paired-end finalization in C++ (finalize_pe_c):
    mem_pair + mem_sam_pe for every (already deduped, batch-rescued) pair
    — byte-identical to the Python contract (align/pairing.py:sam_pe with
    skip_rescue=True). None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    R = len(recs)
    assert R % 2 == 0
    f = _flatten_finalize_inputs(recs, regs_per_read)
    ctg_names, ctg_name_off, ctg_off, ctg_is_alt = _fin_blobs(bns)
    text = np.ascontiguousarray(text, dtype=np.uint8)
    mat = np.ascontiguousarray(opt.mat, dtype=np.int8)
    iopt, dopt = _fin_opts(opt, int(opt.pen_unpaired), int(pair_id0))
    pe_stats = np.zeros((4, 5), np.float64)
    for d in range(4):
        pe_stats[d] = (pes[d].low, pes[d].high, pes[d].failed, pes[d].avg,
                       pes[d].std)
    rg = (rg_id or "").encode()

    if not getattr(lib, "_finpe_sig", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i8p = ctypes.POINTER(ctypes.c_int8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.finalize_pe_c.argtypes = [
            ctypes.c_int32, i32p, i64p, i64p, i32p, i32p, i32p, i32p, i32p,
            i32p, i32p, i32p, i32p, f64p, u8p, u8p, i64p,
            ctypes.c_char_p, i64p, ctypes.c_char_p, i64p, ctypes.c_char_p,
            i64p, u8p, ctypes.c_int64, ctypes.c_int32, i64p,
            ctypes.c_char_p, i64p, u8p, i8p, i64p, f64p, f64p,
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64, i64p,
        ]
        lib.finalize_pe_c.restype = ctypes.c_int64
        lib._finpe_sig = True

    cap = int(sum((len(rec.codes) * 2 + 300) * (len(regs) + 1)
                  for rec, regs in zip(recs, regs_per_read)) + 4096)
    out_off = np.zeros(R + 1, np.int64)
    for _ in range(2):
        buf = ctypes.create_string_buffer(cap)
        total = lib.finalize_pe_c(
            R // 2, _p(f["reg_off"], ctypes.c_int32),
            _p(f["rb"], ctypes.c_int64), _p(f["re"], ctypes.c_int64),
            _p(f["qb"], ctypes.c_int32), _p(f["qe"], ctypes.c_int32),
            _p(f["rid"], ctypes.c_int32), _p(f["score"], ctypes.c_int32),
            _p(f["truesc"], ctypes.c_int32), _p(f["sub"], ctypes.c_int32),
            _p(f["csub"], ctypes.c_int32), _p(f["w"], ctypes.c_int32),
            _p(f["seedcov"], ctypes.c_int32),
            _p(f["frac_rep"], ctypes.c_double),
            _p(f["is_alt"], ctypes.c_uint8),
            _p(f["qcodes"], ctypes.c_uint8), _p(f["qoff"], ctypes.c_int64),
            f["names"], _p(f["name_off"], ctypes.c_int64),
            f["quals"], _p(f["qual_off"], ctypes.c_int64),
            f["comms"], _p(f["comm_off"], ctypes.c_int64),
            _p(text, ctypes.c_uint8), int(bns.l_pac),
            len(bns.contigs), _p(ctg_off, ctypes.c_int64),
            ctg_names, _p(ctg_name_off, ctypes.c_int64),
            _p(ctg_is_alt, ctypes.c_uint8),
            _p(mat, ctypes.c_int8), _p(iopt, ctypes.c_int64),
            _p(dopt, ctypes.c_double),
            _p(pe_stats, ctypes.c_double),
            rg, len(rg), buf, cap, _p(out_off, ctypes.c_int64),
        )
        if total >= 0:
            raw = buf.raw[:total]
            return [raw[out_off[i]: out_off[i + 1]].decode()
                    for i in range(R)]
        cap = int(-total) + 1
    return None


def dedup_batch_native(opt, bns, text, recs, regs_per_read):
    """Whole-batch mem_sort_dedup_patch in C++ (dedup_patch_batch_c) — the
    paired-end kernel-3 prologue (the SE path gets dedup inside
    finalize_se_c). Returns a list of kept-reg lists per read: the CALLER'S
    AlnReg objects, reordered and with the patched fields written back, so
    chain pointers / frac_rep / is_alt survive untouched. None when the
    native library is unavailable. Byte-identical to
    align/finalize.sort_dedup_patch (differentially tested)."""
    lib = _load()
    if lib is None:
        return None
    R = len(recs)
    counts = [len(r) for r in regs_per_read]
    G = sum(counts)
    reg_off = np.zeros(R + 1, np.int32)
    np.cumsum(counts, out=reg_off[1:])
    fields = {}
    for k, dt in (("rb", np.int64), ("re", np.int64), ("qb", np.int32),
                  ("qe", np.int32), ("rid", np.int32), ("score", np.int32),
                  ("truesc", np.int32), ("sub", np.int32),
                  ("csub", np.int32), ("w", np.int32),
                  ("seedcov", np.int32)):
        fields[k] = np.empty(G, dt)
    flat = []
    g = 0
    for regs in regs_per_read:
        for r in regs:
            fields["rb"][g] = r.rb
            fields["re"][g] = r.re
            fields["qb"][g] = r.qb
            fields["qe"][g] = r.qe
            fields["rid"][g] = r.rid
            fields["score"][g] = r.score
            fields["truesc"][g] = r.truesc
            fields["sub"][g] = r.sub
            fields["csub"][g] = r.csub
            fields["w"][g] = r.w
            fields["seedcov"][g] = r.seedcov
            flat.append(r)
            g += 1
    n_comp = np.ones(G, np.int32)
    qoff = np.zeros(R + 1, np.int64)
    np.cumsum([len(rec.codes) for rec in recs], out=qoff[1:])
    qcodes = (np.concatenate([rec.codes for rec in recs]).astype(np.uint8)
              if R else np.zeros(0, np.uint8))
    text = np.ascontiguousarray(text, dtype=np.uint8)
    mat = np.ascontiguousarray(opt.mat, dtype=np.int8)
    iopt, dopt = _fin_opts(opt, 0, 0)

    if not getattr(lib, "_dedup_sig", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i8p = ctypes.POINTER(ctypes.c_int8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.dedup_patch_batch_c.argtypes = [
            ctypes.c_int32, i32p, i64p, i64p, i32p, i32p, i32p, i32p, i32p,
            i32p, i32p, i32p, i32p, i32p, u8p, i64p, u8p, ctypes.c_int64,
            i8p, i64p, f64p, i32p, i32p,
        ]
        lib.dedup_patch_batch_c.restype = ctypes.c_int32
        lib._dedup_sig = True

    out_idx = np.empty(max(G, 1), np.int32)
    out_off = np.zeros(R + 1, np.int32)
    lib.dedup_patch_batch_c(
        R, _p(reg_off, ctypes.c_int32),
        _p(fields["rb"], ctypes.c_int64), _p(fields["re"], ctypes.c_int64),
        _p(fields["qb"], ctypes.c_int32), _p(fields["qe"], ctypes.c_int32),
        _p(fields["rid"], ctypes.c_int32),
        _p(fields["score"], ctypes.c_int32),
        _p(fields["truesc"], ctypes.c_int32),
        _p(fields["sub"], ctypes.c_int32), _p(fields["csub"], ctypes.c_int32),
        _p(fields["w"], ctypes.c_int32), _p(fields["seedcov"], ctypes.c_int32),
        _p(n_comp, ctypes.c_int32),
        _p(qcodes, ctypes.c_uint8), _p(qoff, ctypes.c_int64),
        _p(text, ctypes.c_uint8), int(bns.l_pac),
        _p(mat, ctypes.c_int8), _p(iopt, ctypes.c_int64),
        _p(dopt, ctypes.c_double),
        _p(out_idx, ctypes.c_int32), _p(out_off, ctypes.c_int32))

    out = []
    for li in range(R):
        kept = []
        for k in range(int(out_off[li]), int(out_off[li + 1])):
            gk = int(out_idx[k])
            r = flat[gk]
            r.rb = int(fields["rb"][gk])
            r.re = int(fields["re"][gk])
            r.qb = int(fields["qb"][gk])
            r.qe = int(fields["qe"][gk])
            r.score = int(fields["score"][gk])
            r.truesc = int(fields["truesc"][gk])
            r.sub = int(fields["sub"][gk])
            r.csub = int(fields["csub"][gk])
            r.w = int(fields["w"][gk])
            r.seedcov = int(fields["seedcov"][gk])
            r.n_comp = int(n_comp[gk])
            kept.append(r)
        out.append(kept)
    return out


def build_mode4_rows_native(sa, key_hi, key_lo, isa, wide=False):
    """Fused MODE-4 rank-row assembly (rkm) in one C++ pass; None when the
    native library is unavailable (caller uses the numpy fallback). Wide
    rank rows are (N,5): (pos_lo, pos_hi, key_hi, key_lo, b48). The former
    second output (the kt64 text-position plane) is gone — deep compares
    read the packed text on device (ops/sa_search.py:text64_at)."""
    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_m4_sig", False):
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.build_mode4_rows_c.argtypes = [
            ctypes.c_int64, i64p, u32p, u32p, i64p, u32p,
            ctypes.c_int32]
        lib.build_mode4_rows_c.restype = None
        lib._m4_sig = True
    n = len(sa)
    sa = np.ascontiguousarray(sa, np.int64)
    isa = np.ascontiguousarray(isa, np.int64)
    key_hi = np.ascontiguousarray(key_hi, np.uint32)
    key_lo = np.ascontiguousarray(key_lo, np.uint32)
    rkm = np.empty((n, 5 if wide else 4), np.uint32)
    lib.build_mode4_rows_c(
        n, _p(sa, ctypes.c_int64), _p(key_hi, ctypes.c_uint32),
        _p(key_lo, ctypes.c_uint32), _p(isa, ctypes.c_int64),
        _p(rkm, ctypes.c_uint32),
        ctypes.c_int32(1 if wide else 0))
    return rkm
