// Learned-index SMEM seeding for Hopper (sm_90a): the P-RMI search primitives
// and the three seeding rounds, a warp a read.
//
// Replaces the XLA programs of bwameme_tpu/seeding/engine.py
// (_build_fused_step1 :1081, _build_fused_step2b :823, _build_fused_step3
// :1281) over the search primitives of bwameme_tpu/ops/sa_search.py
// (prmi_window :563, text64_at :593, make_ctx_rk/cmp_ctx_rk :756-852,
// lower_bound_ctx :890, find_longest_ctx :919, interval_at_ctx :937,
// sa_query_min1 :1071, sa_query :1083). On the TPU every read of the batch
// is a lane of one masked while_loop, and each loop step pays for the whole
// batch; here a warp runs one read's state machine to its end, as the scalar
// contract states it (seeding/host_engine.py: step1, one_pos, the third
// round), with data-dependent trip counts. None of the TPU's compile tiers,
// straggler compaction or barriers is carried over: the read length is a
// runtime argument.
//
// What bounds it: latency, not bytes. A probe is a random 16-byte read of a
// rank row in a multi-GB plane, a launch lasts as long as its slowest read's
// chain of dependent loads, and a batch of 4096 reads has too few loads in
// flight to hide any of it. So the design shortens the chain and pays for it
// in bytes, of which the card has plenty:
//
// * A binary search over a P-RMI window is one step: the lanes load the
//   window's consecutive rank rows together (plus a margin of one or two
//   ranks on each side), every lane compares its own suffix with the pattern,
//   a ballot gathers "go right", and the search then walks over the ballot's
//   bits in registers, mid by mid as the scalar search does, so its result is
//   the scalar search's by construction. A window wider than the lanes is
//   first narrowed five levels a step: the 31 nodes of the next five levels
//   of the search tree are probed at once and the walk follows the ballot.
// * A tie of 48 bases or more reads the packed text 128 bases a step, all
//   of a step's words loaded before the first compare.
// * The interval of a match comes without a further load wherever the probed
//   ranks already show it: the interval of pattern[:l] is the run of
//   consecutive ranks whose suffix shares l bases with the pattern, and after
//   the search for the longest match every lane holds its rank's lcp. If a
//   probed rank with a smaller lcp (or the array's end) closes the run on
//   both sides, the bounds follow from a ballot, and the two closing lanes
//   hold the lcps that the next level of a widening needs. A run that touches
//   the edge of the probed ranks (a repeat) takes the two searches of
//   interval_at instead: both leaf records loaded together and, where both
//   windows fit, each searched by half a warp in the same step.
//
// Every lane of a warp runs the same control flow on the same scalars (they
// come from uniform loads, ballots and shuffles), so no lane leaves a loop in
// which the others still meet at a warp primitive; lane 0 writes the slots.
//
// Packed words compare as unsigned (uint32_t). The one float step, the P-RMI
// prediction, rounds its multiply and its add separately (__fmul_rn,
// __fadd_rn; the file is also built with -fmad=false): the error windows of
// models/prmi.py are proven for that arithmetic, and a fused multiply-add
// can put the true lower bound outside the window.

#include <cstdint>
#include <cuda_runtime.h>

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int WARP = 32;
// a min_intv that every interval meets: sa_query then stops at the longest
// match (the reference's sa_query_min1)
constexpr int FIRST_INTERVAL = -2147483647 - 1;

struct Index {
    const uint4* rk;         // (n_sa) rank rows: pos, key_hi, key_lo, b32..48
    const uint32_t* text32;  // packed text + guard words
    long long n_text_words;
    const uint32_t* params;  // (n_leaf, 6) leaf records
    int n_leaf;
    int bits;
    int n_sa;
    // a kernel copies its Index parameter into a local and fills in the rest
    int lane;
    // what the warp counts of itself when asked: the 32-byte sectors of rank
    // rows and packed text this lane brought in, and the warp's dependent
    // steps (a leaf record, a probe of rank rows, 128 bases of text)
    bool counting;
    int sectors;
    int steps;
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
__device__ __forceinline__ int midpoint(int lo, int hi) {
    return (int)(((long long)lo + hi) >> 1);
}

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

// a leaf record of the P-RMI, loaded apart from its use so that two
// records' loads can be in flight together
struct Leaf {
    uint32_t ls, le, alpha, beta, elo, ehi;
};

__device__ __forceinline__ Leaf load_leaf(const Index& ix, uint32_t khi) {
    uint32_t leaf = khi >> (32 - ix.bits);  // bits in 1..31
    if (leaf > (uint32_t)(ix.n_leaf - 1)) leaf = (uint32_t)(ix.n_leaf - 1);
    const uint32_t* rec = ix.params + 6ll * leaf;
    return Leaf{__ldg(rec),     __ldg(rec + 1), __ldg(rec + 2),
                __ldg(rec + 3), __ldg(rec + 4), __ldg(rec + 5)};
}

__device__ __forceinline__ void leaf_window(const Index& ix, const Leaf& r,
                                            uint32_t khi, uint32_t klo,
                                            int& lo, int& hi) {
    const int shift = 32 - ix.bits;
    const uint32_t rel_hi = khi & ((1u << shift) - 1u);
    const float rel = __fadd_rn(
        __fmul_rn(__uint2float_rn(rel_hi), 4294967296.0f),
        __uint2float_rn(klo));
    const int ls = (int)r.ls, le = (int)r.le;
    const float alpha = __uint_as_float(r.alpha);
    const float beta = __uint_as_float(r.beta);
    const int elo = (int)r.elo, ehi = (int)r.ehi;
    const float cnt = __int2float_rn(le - ls);
    float predf = __fadd_rn(alpha, __fmul_rn(beta, rel));
    predf = fminf(fmaxf(predf, 0.0f), cnt);
    const long long pred = (long long)ls + (long long)__float2int_rz(predf);
    const long long l = pred - elo, h = pred + ehi;
    lo = (int)(l < 0 ? 0 : l);
    hi = (int)(h > ix.n_sa ? ix.n_sa : h);
}

__device__ __forceinline__ void prmi_window(const Index& ix, uint32_t khi,
                                            uint32_t klo, int& lo, int& hi) {
    leaf_window(ix, load_leaf(ix, khi), khi, klo, lo, hi);
}

// One lane's compare: (less, lcp) of suffix rank sa_idx against pattern[:v].
// Meets no other lane, so lanes may part ways inside. deep: the steps of
// packed text it read.
__device__ void cmp_rank(Index& ix, const Pat& p, int v, long long sa_idx,
                         bool& less, int& lcp, int& deep) {
    deep = 0;
    if (sa_idx < 0) { less = true; lcp = 0; return; }
    if (sa_idx >= ix.n_sa) { less = false; lcp = 0; return; }
    const uint4 r = __ldg(ix.rk + sa_idx);
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
    // ties of 48 bases or more: the packed text, two 64-base segments a
    // step, every word of the step loaded before the first compare. A
    // segment that starts past the text compares as all ones. The first
    // differing base decides, if it lies inside pattern[:v].
    const long long last = ix.n_text_words - 1;
    for (int off = 48, kw = 3;; off += 128, kw += 8) {
        const int nseg = v - off > 64 ? 2 : 1;
        const long long tp = (long long)r.x + off;
        const long long base = tp >> 4;
        const uint32_t sh = (uint32_t)(tp & 15) * 2u;
        const bool in0 = tp < ix.n_sa, in1 = tp + 64 < ix.n_sa;
        ++deep;
        ix.sectors += (int)(((base + 4 * nseg) >> 3) - (base >> 3)) + 1;
        uint32_t w[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) {
            const long long b = base + j;
            w[j] = j < 5 || nseg == 2
                       ? __ldg(ix.text32 + (b < last ? b : last)) : 0u;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (j == 4 && nseg == 1) break;
            const uint32_t sw =
                (j < 4 ? in0 : in1) ? combine(w[j], w[j + 1], sh) : FULL;
            const uint32_t kwd = pat_word(p, kw + j);
            const uint32_t y = sw ^ kwd;
            if (y != 0u) {
                const int l = off + 16 * j + lcp16(y);
                if (l < v) { less = sw < kwd; lcp = l; } else { lcp = v; }
                return;
            }
        }
        lcp = v;
        if (v - off <= 64 * nseg) return;
    }
}

// The warp's probe of one rank a lane (idle lanes: not less, lcp 0), and its
// count of what that read. Of consecutive ranks two share a sector.
__device__ __forceinline__ void probe(Index& ix, const Pat& p, int v,
                                      long long rank, bool active,
                                      bool consecutive, bool& less, int& lcp) {
    less = false;
    lcp = 0;
    int deep = 0;
    if (active) cmp_rank(ix, p, v, rank, less, lcp, deep);
    if (ix.counting) {
        const bool row = active && rank >= 0 && rank < ix.n_sa;
        const uint32_t rows = __ballot_sync(FULL, row);
        const bool shares = consecutive && (rank & 1) && ix.lane > 0 &&
                            ((rows >> (ix.lane - 1)) & 1u);
        ix.sectors += row && !shares;
        ix.steps += (rows != 0u) + __reduce_max_sync(FULL, deep);
    }
}

// the scalar binary search over [lo, hi], its probes read from the ballot:
// bit k is "go right" of rank first + k
__device__ __forceinline__ int search_bits(uint32_t bits, int first, int lo,
                                           int hi) {
    while (lo < hi) {
        const int mid = midpoint(lo, hi);
        if ((bits >> (mid - first)) & 1u) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Five levels of the scalar binary search over [lo, hi] in one step: lane k
// (1..31) is node k of the search tree in heap order and probes the mid the
// search would probe on reaching that node; then the walk follows the ballot.
__device__ void tree_round(Index& ix, const Pat& p, int v, bool strict,
                           int& lo, int& hi) {
    const int lane = ix.lane;
    int nlo = lo, nhi = hi;
    if (lane > 0)
        for (int d = 30 - __clz(lane); d >= 0 && nlo < nhi; --d) {
            const int mid = midpoint(nlo, nhi);
            if ((lane >> d) & 1) nlo = mid + 1; else nhi = mid;
        }
    const bool alive = lane > 0 && nlo < nhi;
    bool less;
    int lcp;
    probe(ix, p, v, midpoint(nlo, nhi), alive, false, less, lcp);
    const uint32_t bits =
        __ballot_sync(FULL, alive && (less || (strict && lcp >= v)));
    for (int node = 1, d = 0; d < 5 && lo < hi; ++d) {
        const int mid = midpoint(lo, hi);
        const uint32_t b = (bits >> node) & 1u;
        if (b) lo = mid + 1; else hi = mid;
        node = 2 * node + (int)b;
    }
}

// What the lanes hold after a probe of consecutive ranks: lane k the lcp of
// rank first + k against the pattern, for k < n (0 past both ends of the
// suffix array, and in the lanes past n).
struct Lanes {
    int first;
    int n;
    int lcp;
};

// first rank in [lo, hi] whose suffix is >= pattern[:v] (> when strict), as
// the scalar binary search finds it; the last step probes ranks lo - margin
// .. hi + margin - 1 and leaves their lcps in the lanes
__device__ int lower_bound(Index& ix, const Pat& p, int v, int lo, int hi,
                           bool strict, int margin, Lanes& L) {
    while (hi - lo > WARP - 2 * margin) tree_round(ix, p, v, strict, lo, hi);
    L.first = lo - margin;
    L.n = hi - lo + 2 * margin;
    const bool active = ix.lane < L.n;
    bool less;
    probe(ix, p, v, (long long)L.first + ix.lane, active, true, less, L.lcp);
    const uint32_t bits =
        __ballot_sync(FULL, active && (less || (strict && L.lcp >= v)));
    return search_bits(bits, L.first, lo, hi);
}

__device__ __forceinline__ void keep_masks(int l, uint32_t& hi,
                                           uint32_t& lo) {
    const int b = imin(imax(2 * l, 0), 64);
    hi = high_mask(b);
    lo = high_mask(b - 32);
}

// The ranks probed by the search for the longest match, a rank among them
// whose suffix shares those bases, and whether the lanes still hold them.
struct Probed {
    Lanes lanes;
    int anchor;
    bool held;
};

// longest match of pattern[:v] over the suffix array (key padded with ones)
__device__ int find_longest(Index& ix, const Pat& p, int v, Probed& P) {
    uint32_t mh, ml;
    keep_masks(v, mh, ml);
    int wlo, whi;
    prmi_window(ix, (p.k0 & mh) | ~mh, (p.k1 & ml) | ~ml, wlo, whi);
    ix.steps += 1;
    const int ip = lower_bound(ix, p, v, wlo, whi, false, 2, P.lanes);
    const int l0 = __shfl_sync(FULL, P.lanes.lcp, ip - 1 - P.lanes.first);
    const int l1 = __shfl_sync(FULL, P.lanes.lcp, ip - P.lanes.first);
    P.anchor = l0 >= l1 ? ip - 1 : ip;
    P.held = true;
    return imax(l0, l1);
}

// Interval of pattern[:l] by two searches (zeros pad the lower key, ones the
// upper), and b0, b1: the lcps of the ranks that border it, lb - 1 and
// lb + cnt. Both leaf records are loaded together; two windows of at most 14
// ranks are searched in one step, half a warp each.
__device__ void interval_at(Index& ix, const Pat& p, int l, int& lb, int& cnt,
                            int& b0, int& b1) {
    uint32_t mh, ml;
    keep_masks(l, mh, ml);
    const uint32_t ah = p.k0 & mh, al = p.k1 & ml;
    const Leaf ra = load_leaf(ix, ah), rb = load_leaf(ix, ah | ~mh);
    int alo, ahi, blo, bhi, ub;
    leaf_window(ix, ra, ah, al, alo, ahi);
    leaf_window(ix, rb, ah | ~mh, al | ~ml, blo, bhi);
    ix.steps += 1;
    constexpr int HALF = WARP / 2;
    if (ahi - alo <= HALF - 2 && bhi - blo <= HALF - 2) {
        const bool upper = ix.lane >= HALF;
        const int k = ix.lane & (HALF - 1);
        const bool active = k < (upper ? bhi - blo : ahi - alo) + 2;
        bool less;
        int lcp;
        probe(ix, p, l, (long long)(upper ? blo : alo) - 1 + k, active, true,
              less, lcp);
        const uint32_t bits = __ballot_sync(
            FULL, active && (less || (upper && lcp >= l)));
        lb = search_bits(bits & 0xFFFFu, alo - 1, alo, ahi);
        ub = search_bits(bits >> HALF, blo - 1, blo, bhi);
        b0 = __shfl_sync(FULL, lcp, lb - alo);
        b1 = __shfl_sync(FULL, lcp, HALF + ub - blo + 1);
    } else {
        Lanes L;
        lb = lower_bound(ix, p, l, alo, ahi, false, 1, L);
        b0 = __shfl_sync(FULL, L.lcp, lb - 1 - L.first);
        ub = lower_bound(ix, p, l, blo, bhi, true, 1, L);
        b1 = __shfl_sync(FULL, L.lcp, ub - L.first);
    }
    cnt = ub - lb;
}

// The same out of the lanes, with no load, where they show it: the run of
// lanes around the anchor whose lcp is at least l, if a probed rank with a
// smaller lcp closes it on both sides. l is at most the longest match.
__device__ bool lanes_interval(const Probed& P, int l, int& lb, int& cnt,
                               int& b0, int& b1) {
    const Lanes& L = P.lanes;
    const uint32_t probed = L.n >= WARP ? FULL : (1u << L.n) - 1u;
    const uint32_t shorter = ~__ballot_sync(FULL, L.lcp >= l) & probed;
    const int a = P.anchor - L.first;  // 1..30
    const uint32_t below = shorter & ((1u << a) - 1u);
    const uint32_t above = shorter & ~((2u << a) - 1u);
    if (!below || !above) return false;
    const int e0 = 31 - __clz((int)below), e1 = __ffs((int)above) - 1;
    lb = L.first + e0 + 1;
    cnt = e1 - e0 - 1;
    b0 = __shfl_sync(FULL, L.lcp, e0);
    b1 = __shfl_sync(FULL, L.lcp, e1);
    return true;
}

// one level of a walk down the match lengths: from the lanes while they
// show it, by the two searches from then on
__device__ void interval_level(Index& ix, const Pat& p, Probed& P, int l,
                               int& lb, int& cnt, int& b0, int& b1) {
    if (P.held && lanes_interval(P, l, lb, cnt, b0, b1)) return;
    P.held = false;
    interval_at(ix, p, l, lb, cnt, b0, b1);
}

// the widening fixed point: longest l whose interval holds >= min_intv
__device__ void sa_query(Index& ix, const Pat& p, int v, int min_intv,
                         int& mlen, int& lb, int& cnt) {
    Probed P;
    mlen = v <= 0 ? 0 : find_longest(ix, p, v, P);
    for (;;) {
        if (mlen == 0) { lb = 0; cnt = ix.n_sa; return; }
        int b0, b1;
        interval_level(ix, p, P, mlen, lb, cnt, b0, b1);
        if (cnt >= min_intv) return;
        mlen = imax(b0, b1);
    }
}

// ----------------------------------------------------------------- rounds

// A warp a read, four warps a block; eight blocks an SM keep every warp of a
// batch of 4096 reads on the card at once (132 SMs x 32 warps), which holds
// the kernels to 64 registers a thread. Round 2 carries more state (round
// 1's slots, the reseed's bounds): at 64 registers it spills some hundreds
// of bytes and its slowest read's chain runs a fifth longer, so it gets six
// blocks an SM (80 registers, 3168 warps at once), which measured no slower
// at any batch size.
constexpr int READ_THREADS = 4 * WARP;
constexpr int READ_BLOCKS = 8;
constexpr int ROUND2_BLOCKS = 6;

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
// (R, M); an emission past slot M is counted in dropped, never lost silently.
// Every lane keeps the counts, lane 0 writes.
struct Slots {
    int32_t* base;
    long long plane;  // R * M
    int M;
    int n;
    int dropped;
    bool writer;
};

__device__ __forceinline__ void emit(Slots& s, int start, int end, int lb,
                                     int cnt) {
    if (s.n < s.M) {
        if (s.writer) {
            int32_t* q = s.base + s.n;
            q[0] = start;
            q[s.plane] = end;
            q[2 * s.plane] = lb;
            q[3 * s.plane] = cnt;
        }
        ++s.n;
    } else {
        ++s.dropped;
    }
}

// The warp's read (or job) and the lane's place in it; false past the end of
// the batch, where the whole warp leaves. counts, where given, is (2, n):
// the sectors and the dependent steps the warp counted of itself.
__device__ __forceinline__ bool warp_job(Index& ix, int n,
                                         const int32_t* counts, int& i) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    i = t / WARP;
    ix.lane = t % WARP;
    ix.counting = counts != nullptr;
    ix.sectors = ix.steps = 0;
    return i < n;
}

__device__ __forceinline__ void finish(const Slots& s, int i, int32_t* nsm,
                                       int32_t* dropped) {
    if (s.writer) {
        nsm[i] = s.n;
        dropped[i] = s.dropped;
    }
}

__device__ __forceinline__ void write_counts(const Index& ix, int32_t* counts,
                                             int n, int i) {
    if (!counts) return;
    const int sectors = __reduce_add_sync(FULL, ix.sectors);
    if (ix.lane == 0) {
        counts[i] = sectors;
        counts[n + i] = ix.steps;
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
__global__ void __launch_bounds__(READ_THREADS, READ_BLOCKS)
seed_round1_kernel(Index ixp, const uint32_t* qbuf, int W, Tables tb,
                   const int32_t* lens, int R, int minseed, int M,
                   int32_t* slots, int32_t* nsm, int32_t* dropped,
                   int32_t* counts) {
    Index ix = ixp;
    int i;
    if (!warp_job(ix, R, counts, i)) return;
    const int l = lens[i];
    const int32_t* nf = tb.nf + (long long)i * tb.Lp;
    const int32_t* nr = tb.nr + (long long)i * tb.Lp;
    const int32_t* nvf = tb.nvf + (long long)i * tb.Lp;
    Slots s{slots + (long long)i * M, (long long)R * M, M, 0, 0,
            ix.lane == 0};
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
        sa_query(ix, pat, v, FIRST_INTERVAL, mlen, lb, cnt);
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
    finish(s, i, nsm, dropped);
    write_counts(ix, counts, R, i);
}

// round 2: reseed round-1 SMEMs with len >= split_len and hitcount <=
// split_width from their middle at min_intv = hitcount + 1 (host_engine.py
// one_pos, engine.py :823); slots1 are round 1's planes (R, M1)
__global__ void __launch_bounds__(READ_THREADS, ROUND2_BLOCKS)
seed_round2_kernel(Index ixp, const uint32_t* qbuf, int W, Tables tb,
                   const int32_t* lens, int R, const int32_t* slots1,
                   const int32_t* nsm1, int M1, int split_len,
                   int split_width, int minseed, int M, int32_t* slots,
                   int32_t* nsm, int32_t* dropped, int32_t* counts) {
    Index ix = ixp;
    int i;
    if (!warp_job(ix, R, counts, i)) return;
    const int l = lens[i];
    const int32_t* nf = tb.nf + (long long)i * tb.Lp;
    const int32_t* nr = tb.nr + (long long)i * tb.Lp;
    const long long plane1 = (long long)R * M1;
    const int32_t* s1 = slots1 + (long long)i * M1;
    Slots s{slots + (long long)i * M, (long long)R * M, M, 0, 0,
            ix.lane == 0};
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
    finish(s, i, nsm, dropped);
    write_counts(ix, counts, R, i);
}

// round 3: the bwt seed strategy (host_engine.py :271-313, engine.py :1281,
// :1367): at each pivot walk the match levels down from the longest until an
// interval holds min_intv suffixes or the level falls below min_seed
__global__ void __launch_bounds__(READ_THREADS, READ_BLOCKS)
seed_round3_kernel(Index ixp, const uint32_t* qbuf, int W, Tables tb,
                   const int32_t* lens, int R, int min_intv, int min_seed,
                   int M, int32_t* slots, int32_t* nsm, int32_t* dropped,
                   int32_t* counts) {
    Index ix = ixp;
    int i;
    if (!warp_job(ix, R, counts, i)) return;
    const int lim = lens[i] - min_seed + 1;
    const int32_t* nf = tb.nf + (long long)i * tb.Lp;
    Slots s{slots + (long long)i * M, (long long)R * M, M, 0, 0,
            ix.lane == 0};
    int pv = 0;
    while (pv < lim) {
        const int v = tab(nf, tb.Lp, pv) - pv;
        if (v < min_seed) { pv += imax(v, 1); continue; }  // N, short window
        const Pat pat = make_pat(qbuf, W, i, pv);
        Probed P;
        const int lmax = find_longest(ix, pat, v, P);
        if (lmax < min_seed) { pv += imax(min_seed, 1); continue; }
        int cur_l = lmax, lb, cnt, b0, b1, prev_lb = 0, prev_cnt = 0, advance;
        interval_level(ix, pat, P, cur_l, lb, cnt, b0, b1);
        for (;;) {
            if (cnt >= min_intv) {
                if (prev_cnt > 0)
                    emit(s, pv, pv + cur_l + 1, prev_lb, prev_cnt);
                advance = cur_l + 1;
                break;
            }
            const int nxt = imax(b0, b1);
            if (nxt < min_seed) {
                emit(s, pv, pv + min_seed, lb, cnt);
                advance = min_seed;
                break;
            }
            prev_lb = lb;
            prev_cnt = cnt;
            cur_l = imax(nxt, 1);
            interval_level(ix, pat, P, cur_l, lb, cnt, b0, b1);
        }
        pv += imax(advance, 1);
    }
    finish(s, i, nsm, dropped);
    write_counts(ix, counts, R, i);
}

// the primitives alone, to hold them against their plain versions on the
// card: a window is one record a key, so a thread a key; sa_query a warp a job
__global__ void prmi_window_kernel(Index ix, const uint32_t* khi,
                                   const uint32_t* klo, int n, int32_t* lo,
                                   int32_t* hi) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int a, b;
    prmi_window(ix, khi[i], klo[i], a, b);
    lo[i] = a;
    hi[i] = b;
}

__global__ void __launch_bounds__(READ_THREADS, READ_BLOCKS)
sa_query_kernel(Index ixp, const uint32_t* qbuf, int W, const int32_t* row,
                const int32_t* pivot, const int32_t* v,
                const int32_t* min_intv, int n, int32_t* out,
                int32_t* counts) {
    Index ix = ixp;
    int i;
    if (!warp_job(ix, n, counts, i)) return;
    int mlen, lb, cnt;
    sa_query(ix, make_pat(qbuf, W, row[i], pivot[i]), v[i], min_intv[i], mlen,
             lb, cnt);
    if (ix.lane == 0) {
        out[i] = mlen;
        out[n + i] = lb;
        out[2 * n + i] = cnt;
    }
    write_counts(ix, counts, n, i);
}

extern "C" {

static Index make_index(const void* rk, const void* text32,
                        long long n_text_words, const void* params, int n_leaf,
                        int bits, int n_sa) {
    return Index{(const uint4*)rk, (const uint32_t*)text32, n_text_words,
                 (const uint32_t*)params, n_leaf, bits, n_sa, 0, false, 0, 0};
}

static const int KEY_THREADS = 128;

// blocks of n warps' jobs
static int warp_blocks(int n) {
    const int per_block = READ_THREADS / WARP;
    return (n + per_block - 1) / per_block;
}

int seed_round1_launch(const void* rk, const void* text32,
                       long long n_text_words, const void* params, int n_leaf,
                       int bits, int n_sa, const void* qbuf, int W,
                       const void* nf, const void* nr, const void* nvf, int Lp,
                       const void* lens, int R, int minseed, int M,
                       void* slots, void* nsm, void* dropped, void* counts,
                       void* stream) {
    if (R == 0) return 0;
    Tables tb{(const int32_t*)nf, (const int32_t*)nr, (const int32_t*)nvf, Lp};
    seed_round1_kernel<<<warp_blocks(R), READ_THREADS, 0,
                         (cudaStream_t)stream>>>(
        make_index(rk, text32, n_text_words, params, n_leaf, bits, n_sa),
        (const uint32_t*)qbuf, W, tb, (const int32_t*)lens, R, minseed, M,
        (int32_t*)slots, (int32_t*)nsm, (int32_t*)dropped,
        (int32_t*)counts);
    return (int)cudaGetLastError();
}

int seed_round2_launch(const void* rk, const void* text32,
                       long long n_text_words, const void* params, int n_leaf,
                       int bits, int n_sa, const void* qbuf, int W,
                       const void* nf, const void* nr, int Lp,
                       const void* lens, int R, const void* slots1,
                       const void* nsm1, int M1, int split_len,
                       int split_width, int minseed, int M, void* slots,
                       void* nsm, void* dropped, void* counts,
                       void* stream) {
    if (R == 0) return 0;
    Tables tb{(const int32_t*)nf, (const int32_t*)nr, nullptr, Lp};
    seed_round2_kernel<<<warp_blocks(R), READ_THREADS, 0,
                         (cudaStream_t)stream>>>(
        make_index(rk, text32, n_text_words, params, n_leaf, bits, n_sa),
        (const uint32_t*)qbuf, W, tb, (const int32_t*)lens, R,
        (const int32_t*)slots1, (const int32_t*)nsm1, M1, split_len,
        split_width, minseed, M, (int32_t*)slots, (int32_t*)nsm,
        (int32_t*)dropped, (int32_t*)counts);
    return (int)cudaGetLastError();
}

int seed_round3_launch(const void* rk, const void* text32,
                       long long n_text_words, const void* params, int n_leaf,
                       int bits, int n_sa, const void* qbuf, int W,
                       const void* nf, int Lp, const void* lens, int R,
                       int min_intv, int min_seed, int M, void* slots,
                       void* nsm, void* dropped, void* counts,
                       void* stream) {
    if (R == 0) return 0;
    Tables tb{(const int32_t*)nf, nullptr, nullptr, Lp};
    seed_round3_kernel<<<warp_blocks(R), READ_THREADS, 0,
                         (cudaStream_t)stream>>>(
        make_index(rk, text32, n_text_words, params, n_leaf, bits, n_sa),
        (const uint32_t*)qbuf, W, tb, (const int32_t*)lens, R, min_intv,
        min_seed, M, (int32_t*)slots, (int32_t*)nsm, (int32_t*)dropped,
        (int32_t*)counts);
    return (int)cudaGetLastError();
}

int prmi_window_launch(const void* rk, const void* text32,
                       long long n_text_words, const void* params, int n_leaf,
                       int bits, int n_sa, const void* khi, const void* klo,
                       int n, void* lo, void* hi, void* stream) {
    if (n == 0) return 0;
    prmi_window_kernel<<<(n + KEY_THREADS - 1) / KEY_THREADS, KEY_THREADS, 0,
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
                    int n, void* out, void* counts, void* stream) {
    if (n == 0) return 0;
    sa_query_kernel<<<warp_blocks(n), READ_THREADS, 0,
                      (cudaStream_t)stream>>>(
        make_index(rk, text32, n_text_words, params, n_leaf, bits, n_sa),
        (const uint32_t*)qbuf, W, (const int32_t*)row, (const int32_t*)pivot,
        (const int32_t*)v, (const int32_t*)min_intv, n, (int32_t*)out,
        (int32_t*)counts);
    return (int)cudaGetLastError();
}

}  // extern "C"
