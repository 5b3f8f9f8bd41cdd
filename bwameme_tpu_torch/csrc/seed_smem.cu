// Learned-index SMEM seeding for Hopper (sm_90a): the P-RMI search primitives
// and the three seeding rounds, one thread a read.
//
// Replaces the XLA programs of bwameme_tpu/seeding/engine.py
// (_build_fused_step1 :1081, _build_fused_step2b :823, _build_fused_step3
// :1281) over the search primitives of bwameme_tpu/ops/sa_search.py
// (prmi_window :563, text64_at :593, make_ctx_rk/cmp_ctx_rk :756-852,
// lower_bound_ctx :890, find_longest_ctx :919, interval_at_ctx :937,
// sa_query_min1 :1071, sa_query :1083). On the TPU every read of the batch
// is a lane of one masked while_loop, and each loop step pays for the whole
// batch; here one thread runs one read's state machine to its end, as the
// scalar contract states it (seeding/host_engine.py: step1, one_pos, the
// third round), with data-dependent trip counts and no lane masks. None of
// the TPU's compile tiers, straggler compaction or barriers is carried over:
// the read length is a runtime argument.
//
// What bounds it: latency. Every probe of a binary search is a dependent
// random 16-byte read of a rank row in a multi-GB plane (one 32-byte sector);
// a read runs some hundreds of them in sequence, and a warp runs as long as
// its slowest read. The design keeps a probe to one rank-row load (text
// position plus the first 48 bases) and goes to the packed text only for ties
// of 48 bases or more; hiding the latency (more reads in flight, a warp a
// read) is later work.
//
// Packed words compare as unsigned (uint32_t). The one float step, the P-RMI
// prediction, rounds its multiply and its add separately (__fmul_rn,
// __fadd_rn; the file is also built with -fmad=false): the error windows of
// models/prmi.py are proven for that arithmetic, and a fused multiply-add
// can put the true lower bound outside the window.

#include <cstdint>
#include <cuda_runtime.h>

constexpr uint32_t FULL = 0xFFFFFFFFu;

struct Index {
    const uint4* rk;         // (n_sa) rank rows: pos, key_hi, key_lo, b32..48
    const uint32_t* text32;  // packed text + guard words
    long long n_text_words;
    const uint32_t* params;  // (n_leaf, 6) leaf records
    int n_leaf;
    int bits;
    int n_sa;
    // per thread: 32-byte sectors of the index this thread has read (one a
    // rank row, one a 64-base text segment); a kernel copies its Index
    // parameter into a local, so this lives in a register
    int sectors;
};

// the pattern read[pivot:] of one row of the packed query buffer
struct Pat {
    const uint32_t* row;
    int W;         // words in a row
    int w0;        // first word (pivot >> 4, clamped to the row)
    uint32_t sh;   // 2 * (pivot & 15)
    uint32_t k0, k1, k2;  // the first 48 bases
};

__device__ __forceinline__ uint32_t combine(uint32_t w0, uint32_t w1,
                                            uint32_t sh) {
    return sh ? (w0 << sh) | (w1 >> (32u - sh)) : w0;
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// word k of the pattern; never reads past the row's last word
__device__ __forceinline__ uint32_t pat_word(const Pat& p, int k) {
    int a = imin(p.w0 + k, p.W - 1);
    int b = imin(p.w0 + k + 1, p.W - 1);
    return combine(p.row[a], p.row[b], p.sh);
}

__device__ __forceinline__ Pat make_pat(const uint32_t* qbuf, int W, int row,
                                        int pivot) {
    Pat p;
    p.row = qbuf + (long long)row * W;
    p.W = W;
    p.w0 = imin(pivot >> 4, W - 1);
    p.sh = (uint32_t)(pivot & 15) * 2u;
    p.k0 = pat_word(p, 0);
    p.k1 = pat_word(p, 1);
    p.k2 = pat_word(p, 2);
    return p;
}

// leading equal 2-bit bases of a 32-bit xor (0..16)
__device__ __forceinline__ int lcp16(uint32_t x) {
    return x ? (__clz((int)x) >> 1) : 16;
}

// mask with the top nbits (clipped to 0..32) bits set
__device__ __forceinline__ uint32_t high_mask(int nbits) {
    if (nbits <= 0) return 0u;
    if (nbits >= 32) return FULL;
    return ~(FULL >> nbits);
}

__device__ void prmi_window(Index& ix, uint32_t khi, uint32_t klo,
                            int& lo, int& hi) {
    const int shift = 32 - ix.bits;  // bits in 1..31
    uint32_t leaf = khi >> shift;
    if (leaf > (uint32_t)(ix.n_leaf - 1)) leaf = (uint32_t)(ix.n_leaf - 1);
    const uint32_t rel_hi = khi & ((1u << shift) - 1u);
    const float rel = __fadd_rn(
        __fmul_rn(__uint2float_rn(rel_hi), 4294967296.0f),
        __uint2float_rn(klo));
    const uint32_t* rec = ix.params + 6ll * leaf;
    const int ls = (int)rec[0], le = (int)rec[1];
    const float alpha = __uint_as_float(rec[2]);
    const float beta = __uint_as_float(rec[3]);
    const int elo = (int)rec[4], ehi = (int)rec[5];
    const float cnt = __int2float_rn(le - ls);
    float predf = __fadd_rn(alpha, __fmul_rn(beta, rel));
    predf = fminf(fmaxf(predf, 0.0f), cnt);
    const long long pred = (long long)ls + (long long)__float2int_rz(predf);
    const long long l = pred - elo, h = pred + ehi;
    lo = (int)(l < 0 ? 0 : l);
    hi = (int)(h > ix.n_sa ? ix.n_sa : h);
}

// (less, lcp) of suffix rank sa_idx against pattern[:v]
__device__ void cmp_rank(Index& ix, const Pat& p, int v,
                         long long sa_idx, bool& less, int& lcp) {
    if (sa_idx < 0) { less = true; lcp = 0; return; }
    if (sa_idx >= ix.n_sa) { less = false; lcp = 0; return; }
    const uint4 r = __ldg(ix.rk + sa_idx);
    ++ix.sectors;
    int l48 = 48;
    bool lt = false;
    uint32_t x;
    if ((x = r.y ^ p.k0) != 0u) { l48 = lcp16(x); lt = r.y < p.k0; }
    else if ((x = r.z ^ p.k1) != 0u) { l48 = 16 + lcp16(x); lt = r.z < p.k1; }
    else if ((x = r.w ^ p.k2) != 0u) { l48 = 32 + lcp16(x); lt = r.w < p.k2; }
    const int vc = imin(imax(v, 0), 48);
    if (l48 < vc) { less = lt; lcp = l48; return; }
    less = false;
    lcp = vc;
    if (v <= 48) return;
    // ties of 48 bases or more: 64 bases a step from the packed text
    const long long last = ix.n_text_words - 1;
    for (int off = 48, kw = 3;; off += 64, kw += 4) {
        const long long tp = (long long)r.x + off;
        ++ix.sectors;
        const bool in_range = tp < ix.n_sa;
        const long long base = tp >> 4;
        const uint32_t sh = (uint32_t)(tp & 15) * 2u;
        uint32_t w0 = __ldg(ix.text32 + (base < last ? base : last));
        int l64 = 64;
        bool lk = false;
        for (int j = 0; j < 4; ++j) {
            const long long b1 = base + j + 1;
            const uint32_t w1 = __ldg(ix.text32 + (b1 < last ? b1 : last));
            const uint32_t sw = in_range ? combine(w0, w1, sh) : FULL;
            const uint32_t kwd = pat_word(p, kw + j);
            const uint32_t y = sw ^ kwd;
            if (y != 0u) { l64 = 16 * j + lcp16(y); lk = sw < kwd; break; }
            w0 = w1;
        }
        const int rem = v - off;
        const int vck = imin(imax(rem, 0), 64);
        if (l64 < vck) { less = lk; lcp = off + l64; return; }
        lcp = off + vck;
        if (rem <= 64) return;
    }
}

__device__ __forceinline__ int lcp_rank(Index& ix, const Pat& p, int v,
                                        long long sa_idx) {
    bool less;
    int lcp;
    cmp_rank(ix, p, v, sa_idx, less, lcp);
    return lcp;
}

// first rank in [lo, hi] whose suffix is >= pattern[:v] (> when strict)
__device__ int lower_bound(Index& ix, const Pat& p, int v, int lo,
                           int hi, bool strict) {
    while (lo < hi) {
        const int mid = (int)(((long long)lo + hi) >> 1);
        bool less;
        int lcp;
        cmp_rank(ix, p, v, mid, less, lcp);
        if (less || (strict && lcp >= v)) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ void keep_masks(int l, uint32_t& hi,
                                           uint32_t& lo) {
    const int b = imin(imax(2 * l, 0), 64);
    hi = high_mask(b);
    lo = high_mask(b - 32);
}

// longest match of pattern[:v] over the suffix array (key padded with ones)
__device__ int find_longest(Index& ix, const Pat& p, int v) {
    uint32_t mh, ml;
    keep_masks(v, mh, ml);
    int wlo, whi;
    prmi_window(ix, (p.k0 & mh) | ~mh, (p.k1 & ml) | ~ml, wlo, whi);
    const int ip = lower_bound(ix, p, v, wlo, whi, false);
    return imax(lcp_rank(ix, p, v, (long long)ip - 1), lcp_rank(ix, p, v, ip));
}

// interval of pattern[:l]: zeros pad the lower key, ones the upper
__device__ void interval_at(Index& ix, const Pat& p, int l, int& lb,
                            int& cnt) {
    uint32_t mh, ml;
    keep_masks(l, mh, ml);
    const uint32_t ah = p.k0 & mh, al = p.k1 & ml;
    int wlo, whi;
    prmi_window(ix, ah, al, wlo, whi);
    lb = lower_bound(ix, p, l, wlo, whi, false);
    prmi_window(ix, ah | ~mh, al | ~ml, wlo, whi);
    cnt = lower_bound(ix, p, l, wlo, whi, true) - lb;
}

__device__ void sa_query_min1(Index& ix, const Pat& p, int v, int& mlen,
                              int& lb, int& cnt) {
    mlen = v <= 0 ? 0 : find_longest(ix, p, v);
    if (mlen == 0) { lb = 0; cnt = ix.n_sa; return; }
    interval_at(ix, p, mlen, lb, cnt);
}

// the widening fixed point: longest l whose interval holds >= min_intv
__device__ void sa_query(Index& ix, const Pat& p, int v, int min_intv,
                         int& mlen, int& lb, int& cnt) {
    mlen = v <= 0 ? 0 : find_longest(ix, p, v);
    for (;;) {
        if (mlen == 0) { lb = 0; cnt = ix.n_sa; return; }
        interval_at(ix, p, mlen, lb, cnt);
        if (cnt >= min_intv) return;
        mlen = imax(lcp_rank(ix, p, mlen, (long long)lb - 1),
                    lcp_rank(ix, p, mlen, (long long)lb + cnt));
    }
}

// ----------------------------------------------------------------- rounds

// per-read tables (R, Lp): next N at or after a position (forward read,
// reverse complement) and next non-N; positions clip to the table
struct Tables {
    const int32_t* nf;
    const int32_t* nr;
    const int32_t* nvf;
    int Lp;
};

__device__ __forceinline__ int tab(const int32_t* t, int Lp, int pos) {
    return t[imin(imax(pos, 0), Lp - 1)];
}

// emission slots of one round: 4 planes (start, end, sa_lo, hitcount) of
// (R, M); an emission past slot M is counted in dropped, never lost silently
struct Slots {
    int32_t* base;
    long long plane;  // R * M
    int M;
    int n;
    int dropped;
};

__device__ __forceinline__ void emit(Slots& s, int start, int end, int lb,
                                     int cnt) {
    if (s.n < s.M) {
        int32_t* q = s.base + s.n;
        q[0] = start;
        q[s.plane] = end;
        q[2 * s.plane] = lb;
        q[3 * s.plane] = cnt;
        ++s.n;
    } else {
        ++s.dropped;
    }
}

// skip Ns from pivot: q = next non-N; done when the read ends or what is
// left after an N is shorter than a seed
__device__ __forceinline__ bool skip_ns(const int32_t* nvf, int Lp, int l,
                                        int minseed, int pivot, int& q) {
    q = tab(nvf, Lp, pivot);
    return pivot >= l || (q > pivot && q - 1 >= l - minseed + 1) || q >= l;
}

enum { DONE = 0, RIGHT0 = 1, LEFT = 2, RIGHT_Z = 3 };

__device__ __forceinline__ int enter_outer(const int32_t* nf,
                                           const int32_t* nvf, int Lp, int l,
                                           int minseed, int pivot, int& p) {
    int q;
    const bool done = skip_ns(nvf, Lp, l, minseed, pivot, q);
    p = q;
    if (done) return DONE;
    const bool prev_valid = q != 0 && tab(nf, Lp, q - 1) != q - 1;
    return prev_valid ? LEFT : RIGHT0;
}

// round 1: the zigzag sweep (host_engine.py step1, engine.py :1081)
__global__ void seed_round1_kernel(Index ixp, const uint32_t* qbuf, int W,
                                   Tables tb, const int32_t* lens, int R,
                                   int minseed, int M, int32_t* slots,
                                   int32_t* nsm, int32_t* dropped,
                                   int32_t* sectors) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R) return;
    Index ix = ixp;
    const int l = lens[i];
    const int32_t* nf = tb.nf + (long long)i * tb.Lp;
    const int32_t* nr = tb.nr + (long long)i * tb.Lp;
    const int32_t* nvf = tb.nvf + (long long)i * tb.Lp;
    Slots s{slots + (long long)i * M, (long long)R * M, M, 0, 0};
    int p = 0, spb = 0, phase = DONE;
    if (l >= minseed) {
        phase = enter_outer(nf, nvf, tb.Lp, l, minseed, 0, p);
        spb = p;
    }
    while (phase != DONE) {
        const bool left = phase == LEFT;
        const int lp = l - 1 - p;
        const int piv = left ? lp : p;
        const int v = left ? tab(nr, tb.Lp, lp) - lp : tab(nf, tb.Lp, p) - p;
        const Pat pat = make_pat(qbuf, W, left ? R + i : i, piv);
        int mlen, lb, cnt;
        sa_query_min1(ix, pat, v, mlen, lb, cnt);
        if (left) {
            p = p - mlen + 1;
            phase = l - p < minseed ? DONE : RIGHT_Z;
            continue;
        }
        if (mlen >= minseed) emit(s, p, p + mlen, lb, cnt);
        if (phase == RIGHT_Z) {
            int sp = p + mlen;
            if (sp <= spb) sp = spb + 1;  // progress guard
            int q;
            phase = skip_ns(nvf, tb.Lp, l, minseed, sp, q) ? DONE : LEFT;
            p = spb = q;
        } else {
            phase = enter_outer(nf, nvf, tb.Lp, l, minseed,
                                p + imax(mlen, 1), p);
            spb = p;
        }
    }
    nsm[i] = s.n;
    dropped[i] = s.dropped;
    if (sectors) sectors[i] = ix.sectors;
}

// round 2: reseed round-1 SMEMs with len >= split_len and hitcount <=
// split_width from their middle at min_intv = hitcount + 1 (host_engine.py
// one_pos, engine.py :823); slots1 are round 1's planes (R, M1)
__global__ void seed_round2_kernel(Index ixp, const uint32_t* qbuf, int W,
                                   Tables tb, const int32_t* lens, int R,
                                   const int32_t* slots1,
                                   const int32_t* nsm1, int M1, int split_len,
                                   int split_width, int minseed, int M,
                                   int32_t* slots, int32_t* nsm,
                                   int32_t* dropped, int32_t* sectors) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R) return;
    Index ix = ixp;
    const int l = lens[i];
    const int32_t* nf = tb.nf + (long long)i * tb.Lp;
    const int32_t* nr = tb.nr + (long long)i * tb.Lp;
    const long long plane1 = (long long)R * M1;
    const int32_t* s1 = slots1 + (long long)i * M1;
    Slots s{slots + (long long)i * M, (long long)R * M, M, 0, 0};
    const int n1 = nsm1[i];
    int mlen, lb, cnt;
    for (int k = 0; k < n1; ++k) {
        const int st = s1[k], en = s1[plane1 + k], cn = s1[3 * plane1 + k];
        if (en - st < split_len || cn > split_width) continue;
        const int piv = (st + en) >> 1;
        if (tab(nf, tb.Lp, piv) == piv) continue;  // an N at the pivot
        const int mi = cn + 1;
        const bool prev_valid = piv > 0 && tab(nf, tb.Lp, piv - 1) != piv - 1;
        sa_query(ix, make_pat(qbuf, W, i, piv), tab(nf, tb.Lp, piv) - piv, mi,
                 mlen, lb, cnt);
        if (!prev_valid) {
            if (mlen >= minseed) emit(s, piv, piv + mlen, lb, cnt);
            continue;
        }
        const int npv = piv + mlen;
        int p = piv, psp = piv;
        while (p < npv) {
            const int lp = l - 1 - p;
            sa_query(ix, make_pat(qbuf, W, R + i, lp),
                     tab(nr, tb.Lp, lp) - lp, mi, mlen, lb, cnt);
            p = p - mlen + 1;
            if (npv - p < minseed) break;
            sa_query(ix, make_pat(qbuf, W, i, p), tab(nf, tb.Lp, p) - p, mi,
                     mlen, lb, cnt);
            if (mlen >= minseed) emit(s, p, p + mlen, lb, cnt);
            int sp = p + mlen;
            if (sp <= psp) sp = psp + 1;  // progress guard
            p = psp = sp;
        }
    }
    nsm[i] = s.n;
    dropped[i] = s.dropped;
    if (sectors) sectors[i] = ix.sectors;
}

// round 3: the bwt seed strategy (host_engine.py :271-313, engine.py :1281,
// :1367): at each pivot walk the match levels down from the longest until an
// interval holds min_intv suffixes or the level falls below min_seed
__global__ void seed_round3_kernel(Index ixp, const uint32_t* qbuf, int W,
                                   Tables tb, const int32_t* lens, int R,
                                   int min_intv, int min_seed, int M,
                                   int32_t* slots, int32_t* nsm,
                                   int32_t* dropped, int32_t* sectors) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R) return;
    Index ix = ixp;
    const int lim = lens[i] - min_seed + 1;
    const int32_t* nf = tb.nf + (long long)i * tb.Lp;
    Slots s{slots + (long long)i * M, (long long)R * M, M, 0, 0};
    int pv = 0;
    while (pv < lim) {
        const int v = tab(nf, tb.Lp, pv) - pv;
        if (v < min_seed) { pv += imax(v, 1); continue; }  // N, short window
        const Pat pat = make_pat(qbuf, W, i, pv);
        const int lmax = find_longest(ix, pat, v);
        if (lmax < min_seed) { pv += imax(min_seed, 1); continue; }
        int cur_l = lmax, lb, cnt, prev_lb = 0, prev_cnt = 0, advance;
        interval_at(ix, pat, cur_l, lb, cnt);
        for (;;) {
            if (cnt >= min_intv) {
                if (prev_cnt > 0)
                    emit(s, pv, pv + cur_l + 1, prev_lb, prev_cnt);
                advance = cur_l + 1;
                break;
            }
            const int nxt =
                imax(lcp_rank(ix, pat, cur_l, (long long)lb - 1),
                     lcp_rank(ix, pat, cur_l, (long long)lb + cnt));
            if (nxt < min_seed) {
                emit(s, pv, pv + min_seed, lb, cnt);
                advance = min_seed;
                break;
            }
            prev_lb = lb;
            prev_cnt = cnt;
            cur_l = imax(nxt, 1);
            interval_at(ix, pat, cur_l, lb, cnt);
        }
        pv += imax(advance, 1);
    }
    nsm[i] = s.n;
    dropped[i] = s.dropped;
    if (sectors) sectors[i] = ix.sectors;
}

// the primitives alone, one thread a job, to hold them against their plain
// versions on the card
__global__ void prmi_window_kernel(Index ixp, const uint32_t* khi,
                                   const uint32_t* klo, int n, int32_t* lo,
                                   int32_t* hi) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Index ix = ixp;
    int a, b;
    prmi_window(ix, khi[i], klo[i], a, b);
    lo[i] = a;
    hi[i] = b;
}

__global__ void sa_query_kernel(Index ixp, const uint32_t* qbuf, int W,
                                const int32_t* row, const int32_t* pivot,
                                const int32_t* v, const int32_t* min_intv,
                                int n, int32_t* out, int32_t* sectors) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Index ix = ixp;
    int mlen, lb, cnt;
    sa_query(ix, make_pat(qbuf, W, row[i], pivot[i]), v[i], min_intv[i], mlen,
             lb, cnt);
    out[i] = mlen;
    out[n + i] = lb;
    out[2 * n + i] = cnt;
    if (sectors) sectors[i] = ix.sectors;
}

extern "C" {

static Index make_index(const void* rk, const void* text32,
                        long long n_text_words, const void* params, int n_leaf,
                        int bits, int n_sa) {
    return Index{(const uint4*)rk, (const uint32_t*)text32, n_text_words,
                 (const uint32_t*)params, n_leaf, bits, n_sa, 0};
}

// one read a thread, one warp a block: the blocks of a batch of 4096 reads
// spread over all SMs
static const int READ_THREADS = 32;
static const int JOB_THREADS = 128;

int seed_round1_launch(const void* rk, const void* text32,
                       long long n_text_words, const void* params, int n_leaf,
                       int bits, int n_sa, const void* qbuf, int W,
                       const void* nf, const void* nr, const void* nvf, int Lp,
                       const void* lens, int R, int minseed, int M,
                       void* slots, void* nsm, void* dropped, void* sectors,
                       void* stream) {
    if (R == 0) return 0;
    Tables tb{(const int32_t*)nf, (const int32_t*)nr, (const int32_t*)nvf, Lp};
    seed_round1_kernel<<<(R + READ_THREADS - 1) / READ_THREADS, READ_THREADS,
                         0, (cudaStream_t)stream>>>(
        make_index(rk, text32, n_text_words, params, n_leaf, bits, n_sa),
        (const uint32_t*)qbuf, W, tb, (const int32_t*)lens, R, minseed, M,
        (int32_t*)slots, (int32_t*)nsm, (int32_t*)dropped,
        (int32_t*)sectors);
    return (int)cudaGetLastError();
}

int seed_round2_launch(const void* rk, const void* text32,
                       long long n_text_words, const void* params, int n_leaf,
                       int bits, int n_sa, const void* qbuf, int W,
                       const void* nf, const void* nr, int Lp,
                       const void* lens, int R, const void* slots1,
                       const void* nsm1, int M1, int split_len,
                       int split_width, int minseed, int M, void* slots,
                       void* nsm, void* dropped, void* sectors,
                       void* stream) {
    if (R == 0) return 0;
    Tables tb{(const int32_t*)nf, (const int32_t*)nr, nullptr, Lp};
    seed_round2_kernel<<<(R + READ_THREADS - 1) / READ_THREADS, READ_THREADS,
                         0, (cudaStream_t)stream>>>(
        make_index(rk, text32, n_text_words, params, n_leaf, bits, n_sa),
        (const uint32_t*)qbuf, W, tb, (const int32_t*)lens, R,
        (const int32_t*)slots1, (const int32_t*)nsm1, M1, split_len,
        split_width, minseed, M, (int32_t*)slots, (int32_t*)nsm,
        (int32_t*)dropped, (int32_t*)sectors);
    return (int)cudaGetLastError();
}

int seed_round3_launch(const void* rk, const void* text32,
                       long long n_text_words, const void* params, int n_leaf,
                       int bits, int n_sa, const void* qbuf, int W,
                       const void* nf, int Lp, const void* lens, int R,
                       int min_intv, int min_seed, int M, void* slots,
                       void* nsm, void* dropped, void* sectors,
                       void* stream) {
    if (R == 0) return 0;
    Tables tb{(const int32_t*)nf, nullptr, nullptr, Lp};
    seed_round3_kernel<<<(R + READ_THREADS - 1) / READ_THREADS, READ_THREADS,
                         0, (cudaStream_t)stream>>>(
        make_index(rk, text32, n_text_words, params, n_leaf, bits, n_sa),
        (const uint32_t*)qbuf, W, tb, (const int32_t*)lens, R, min_intv,
        min_seed, M, (int32_t*)slots, (int32_t*)nsm, (int32_t*)dropped,
        (int32_t*)sectors);
    return (int)cudaGetLastError();
}

int prmi_window_launch(const void* rk, const void* text32,
                       long long n_text_words, const void* params, int n_leaf,
                       int bits, int n_sa, const void* khi, const void* klo,
                       int n, void* lo, void* hi, void* stream) {
    if (n == 0) return 0;
    prmi_window_kernel<<<(n + JOB_THREADS - 1) / JOB_THREADS, JOB_THREADS, 0,
                         (cudaStream_t)stream>>>(
        make_index(rk, text32, n_text_words, params, n_leaf, bits, n_sa),
        (const uint32_t*)khi, (const uint32_t*)klo, n, (int32_t*)lo,
        (int32_t*)hi);
    return (int)cudaGetLastError();
}

int sa_query_launch(const void* rk, const void* text32, long long n_text_words,
                    const void* params, int n_leaf, int bits, int n_sa,
                    const void* qbuf, int W, const void* row,
                    const void* pivot, const void* v, const void* min_intv,
                    int n, void* out, void* sectors, void* stream) {
    if (n == 0) return 0;
    sa_query_kernel<<<(n + JOB_THREADS - 1) / JOB_THREADS, JOB_THREADS, 0,
                      (cudaStream_t)stream>>>(
        make_index(rk, text32, n_text_words, params, n_leaf, bits, n_sa),
        (const uint32_t*)qbuf, W, (const int32_t*)row, (const int32_t*)pivot,
        (const int32_t*)v, (const int32_t*)min_intv, n, (int32_t*)out,
        (int32_t*)sectors);
    return (int)cudaGetLastError();
}

}  // extern "C"
