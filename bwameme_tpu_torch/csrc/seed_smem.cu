// Learned-index and ERT SMEM seeding for Hopper (sm_90a): the search
// primitives from a P-RMI or a k-mer root and the three seeding rounds, a
// warp a read.
//
// Replaces the XLA programs of bwameme_tpu/seeding/engine.py
// (_build_fused_step1 :1081, _build_fused_step2b :823, _build_fused_step3
// :1281) over the search primitives of bwameme_tpu/ops/sa_search.py
// (kmer_window :556, prmi_window :563, text64_at :593, make_ctx_rk/
// cmp_ctx_rk :756-852, lower_bound_ctx :890, find_longest_ctx :919,
// interval_at_ctx :937, sa_query_min1 :1071, sa_query :1083). On the TPU every read of the batch
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
// One design serves every layout of the index (index/device.py): each entry
// point is a template on the memory mode (1-4), on the rank type (int, or
// long long for a wide index of 2^31 suffixes or more) and on the root,
// sixteen variants. The mode changes only the head of a compare, where the
// suffix's first bases come from: 48 from the rank row (mode 4), 32 from
// ktext at the position (3) or from key2 beside it (2), none (1); the
// position comes from the row or from sa[r]. From the first base the head
// does not cover, every variant walks the packed text. A wide index reads its
// leaf starts from params64.
//
// The root changes only where a search's first window comes from
// (bwameme_tpu/ops/sa_search.py:591): the P-RMI leaf record's prediction,
// or, for the ERT backend (KMER), the k-mer table's entries m and m + 1 of
// the key's first kmer_bits bases (:556), loaded as a leaf record is. Its
// windows are exact, every rank of the k-mer: narrow on a random text (3
// ranks on average at 100 Mbp under a 13-base root), as wide as a repeat's
// copies elsewhere, which tree_round narrows as it narrows a coarse
// P-RMI's. A template parameter, not a branch: an untaken branch cost narrow
// round 2 up to 23% on an H100 (PERF.md).
//
// Every lane of a warp runs the same control flow on the same scalars (they
// come from uniform loads, ballots and shuffles), so no lane leaves a loop in
// which the others still meet at a warp primitive; lane 0 writes the slots.
//
// Built with SEED_SHARDED, the same source gives the sharded variants
// (ops/build.py builds them into libraries of their own, so that the whole
// index's variants keep their code): the index's per-suffix planes (rank
// rows, positions, keys) lie in equal blocks of block_rows rows, and a rank
// r (or, for mode 3's keys, a position) is row r - b * block_rows of block
// b = r / block_rows. It is the counterpart of the JAX package's sharded
// gathers (bwameme_tpu/ops/sa_search.py:495-506 _owned,
// bwameme_tpu/parallel/sharded_index.py:137-146 owned), which psum every
// shard's masked row: here the block that owns the row answers alone,
// through an ordinary pointer where it shares the card, a peer pointer over
// NVLink where it does not. Only load_head differs, and what it adds to a
// probe's chain of dependent loads is kept off global memory: each thread
// block first copies the blocks' starts and base addresses into shared
// memory (at most MAX_BLOCKS blocks), and a probe finds b with no division,
// as the high word of r times a reciprocal the host computed, corrected by
// one compare against the next block's start (owner; index/device.py
// block_of does the same in integers).
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
template <typename RT> __host__ __device__ constexpr RT first_interval() {
    return sizeof(RT) == 4 ? (RT)(-2147483647 - 1)
                           : (RT)(-9223372036854775807LL - 1);
}

// the first bases of a suffix that a compare takes from the mode's planes
template <int MODE> __host__ __device__ constexpr int head_bases() {
    return MODE == 4 ? 48 : MODE == 1 ? 0 : 32;
}

// RT: the rank (and position) type, int or long long
template <typename RT> struct Index {
    const uint32_t* rk;      // mode 4: (n_sa) rank rows, 4 words (pos,
                             // key_hi, key_lo, b32..48) or 5 (pos_lo, pos_hi,
                             // key_hi, key_lo, b32..48)
    const RT* sa;            // modes 1-3: (n_sa) positions by rank
    const uint2* keys;       // mode 3: 32-base keys by text position (ktext);
                             // mode 2: by rank (key2)
    const uint32_t* text32;  // packed text + guard words
    long long n_text_words;
    const uint32_t* params;  // (n_leaf, 6) leaf records
    const long long* params64;  // wide: (n_leaf + 1) leaf starts
    int n_leaf;
    int bits;
    RT n_sa;
    const RT* kmer_table;    // ERT root: (4^kmer_bits + 1) first ranks
    int kmer_bits;
    // a kernel copies its Index parameter into a local and fills in the rest
    int lane;
    // what the warp counts of itself when asked: the 32-byte sectors of rank
    // rows and packed text this lane brought in, and the warp's dependent
    // steps (a leaf record, a probe of rank rows, 128 bases of text)
    bool counting;
    int sectors;
    int steps;
#ifdef SEED_SHARDED
    // the tables of the blocks' base addresses of the rank-indexed plane
    // (rk, or sa) and of the keys (ktext or key2), on the launch's card;
    // the rows a block, and floor(2^32 / block_rows) (narrow) or
    // floor(2^64 / block_rows) (wide), at most 2^32 - 1 or 2^64 - 1
    const long long* rank_blocks;
    const long long* key_blocks;
    RT block_rows;
    unsigned long long recip;
    int n_blocks;
    // bit b: block b lies on another card than the launch's. Counting, a
    // lane's last probe: bit 0 its row's block was remote, bit 1 (mode 3)
    // its key's; the warp's dependent steps that waited on a remote block
    uint32_t remote;
    uint32_t far;
    int remote_steps;
#endif
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
template <typename RT>
__device__ __forceinline__ RT midpoint(RT lo, RT hi) {
    if constexpr (sizeof(RT) == 4) return (int)(((long long)lo + hi) >> 1);
    else return (lo + hi) >> 1;
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
// records' loads can be in flight together; a wide index's leaf starts
// come from params64
struct Leaf {
    uint32_t ls, le, alpha, beta, elo, ehi;
    long long ls64, le64;
};

template <typename RT>
__device__ __forceinline__ Leaf load_leaf(const Index<RT>& ix, uint32_t khi) {
    uint32_t leaf = khi >> (32 - ix.bits);  // bits in 1..31
    if (leaf > (uint32_t)(ix.n_leaf - 1)) leaf = (uint32_t)(ix.n_leaf - 1);
    const uint32_t* rec = ix.params + 6ll * leaf;
    Leaf r{__ldg(rec),     __ldg(rec + 1), __ldg(rec + 2),
           __ldg(rec + 3), __ldg(rec + 4), __ldg(rec + 5), 0, 0};
    if constexpr (sizeof(RT) == 8) {
        r.ls64 = __ldg(ix.params64 + leaf);
        r.le64 = __ldg(ix.params64 + leaf + 1);
    }
    return r;
}

// In a wide leaf the prediction can pass 2^31: it converts to long long
// (__float2ll_rz), where __float2int_rz would saturate.
template <typename RT>
__device__ __forceinline__ void leaf_window(const Index<RT>& ix,
                                            const Leaf& r, uint32_t khi,
                                            uint32_t klo, RT& lo, RT& hi) {
    const int shift = 32 - ix.bits;
    const uint32_t rel_hi = khi & ((1u << shift) - 1u);
    const float rel = __fadd_rn(
        __fmul_rn(__uint2float_rn(rel_hi), 4294967296.0f),
        __uint2float_rn(klo));
    const float alpha = __uint_as_float(r.alpha);
    const float beta = __uint_as_float(r.beta);
    const int elo = (int)r.elo, ehi = (int)r.ehi;
    long long pred;
    if constexpr (sizeof(RT) == 4) {
        const int ls = (int)r.ls, le = (int)r.le;
        const float cnt = __int2float_rn(le - ls);
        float predf = __fadd_rn(alpha, __fmul_rn(beta, rel));
        predf = fminf(fmaxf(predf, 0.0f), cnt);
        pred = (long long)ls + (long long)__float2int_rz(predf);
    } else {
        const float cnt = __ll2float_rn(r.le64 - r.ls64);
        float predf = __fadd_rn(alpha, __fmul_rn(beta, rel));
        predf = fminf(fmaxf(predf, 0.0f), cnt);
        pred = r.ls64 + __float2ll_rz(predf);
    }
    const long long l = pred - elo, h = pred + ehi;
    lo = (RT)(l < 0 ? 0 : l);
    hi = (RT)(h > ix.n_sa ? ix.n_sa : h);
}

// The root of a search, loaded apart from its use as a leaf record is: the
// P-RMI leaf record of the key, or the k-mer table's entries m and m + 1 of
// its first kmer_bits bases (in ls64 and le64; m clipped to the table).
template <bool KMER, typename RT>
__device__ __forceinline__ Leaf load_root(const Index<RT>& ix, uint32_t khi) {
    if constexpr (KMER) {
        const uint32_t last = (1u << (2 * ix.kmer_bits)) - 1u;
        uint32_t m = khi >> (32 - 2 * ix.kmer_bits);  // kmer_bits in 1..16
        if (m > last) m = last;
        Leaf r{};
        r.ls64 = (long long)__ldg(ix.kmer_table + m);
        r.le64 = (long long)__ldg(ix.kmer_table + m + 1);
        return r;
    } else {
        return load_leaf(ix, khi);
    }
}

template <bool KMER, typename RT>
__device__ __forceinline__ void root_window(const Index<RT>& ix,
                                            const Leaf& r, uint32_t khi,
                                            uint32_t klo, RT& lo, RT& hi) {
    if constexpr (KMER) {
        lo = (RT)r.ls64;
        hi = (RT)r.le64;
    } else {
        leaf_window(ix, r, khi, klo, lo, hi);
    }
}

// The head of the suffix at rank r (in range): its text position, and its
// first head_bases<MODE>() bases in h, 16 a word.
#ifndef SEED_SHARDED
template <int MODE, typename RT>
__device__ __forceinline__ long long load_head(const Index<RT>& ix,
                                               long long r, uint32_t* h) {
    if constexpr (MODE == 4 && sizeof(RT) == 4) {
        const uint4 row = __ldg(reinterpret_cast<const uint4*>(ix.rk) + r);
        h[0] = row.y;
        h[1] = row.z;
        h[2] = row.w;
        return row.x;
    } else if constexpr (MODE == 4) {
        // 20-byte rows are not 16-byte aligned: five words (on an H100
        // 1-3% faster than the two aligned uint4 that hold a row, PERF.md)
        const uint32_t* w = ix.rk + 5 * r;
        const uint32_t lo = __ldg(w), hi = __ldg(w + 1);
        h[0] = __ldg(w + 2);
        h[1] = __ldg(w + 3);
        h[2] = __ldg(w + 4);
        return (long long)(((unsigned long long)hi << 32) | lo);
    } else {
        const long long pos = (long long)__ldg(ix.sa + r);
        if constexpr (MODE != 1) {
            const uint2 k = __ldg(ix.keys + (MODE == 3 ? pos : r));
            h[0] = k.x;
            h[1] = k.y;
        }
        return pos;
    }
}
template <typename RT>
__device__ __forceinline__ void load_blocks(const Index<RT>&) {}
#else
// the most blocks a sharded plane may have (index/device.py MAX_BLOCKS)
constexpr int MAX_BLOCKS = 32;
// the thread block's copy of the blocks' first rows and base addresses
// (rank plane, keys); entry n_blocks is the end of the last block
__shared__ long long s_start[MAX_BLOCKS + 1];
__shared__ const char* s_rank[MAX_BLOCKS + 1];
__shared__ const char* s_key[MAX_BLOCKS + 1];

// every thread of the block calls it before its warp's first probe
template <typename RT>
__device__ __forceinline__ void load_blocks(const Index<RT>& ix) {
    for (int b = threadIdx.x; b <= ix.n_blocks; b += blockDim.x) {
        const bool in = b < ix.n_blocks;
        s_start[b] = (long long)b * ix.block_rows;
        s_rank[b] = in ? (const char*)__ldg(ix.rank_blocks + b) : nullptr;
        s_key[b] = in && ix.key_blocks
                       ? (const char*)__ldg(ix.key_blocks + b) : nullptr;
    }
    __syncthreads();
}

// The block b that owns row r (a rank, or a text position; r < n_sa) of a
// plane, and the row's place in it: q = hi(r * recip) is r / block_rows or
// one less (recip undershoots 2^k / block_rows by less than one, and
// r < 2^k), which the compare against block q + 1's start settles. The
// starts and both candidates' bases are loaded together from shared
// memory: between r and the row's own load there is no division and no
// global load.
template <typename T, bool KEY, typename RT>
__device__ __forceinline__ const T* owner(const Index<RT>& ix, long long r,
                                          long long& row, int& b) {
    if constexpr (sizeof(RT) == 4)
        b = (int)__umulhi((uint32_t)r, (uint32_t)ix.recip);
    else
        b = (int)__umul64hi((unsigned long long)r, ix.recip);
    const char* const* base = KEY ? s_key : s_rank;
    const long long s0 = s_start[b], s1 = s_start[b + 1];
    const char* p0 = base[b];
    const char* p1 = base[b + 1];
    const bool up = r >= s1;
    row = r - (up ? s1 : s0);
    b += up;
    return reinterpret_cast<const T*>(up ? p1 : p0);
}

template <int MODE, typename RT>
__device__ __forceinline__ long long load_head(Index<RT>& ix, long long r,
                                               uint32_t* h) {
    long long o;
    int b;
    if constexpr (MODE == 4 && sizeof(RT) == 4) {
        const uint4 row = __ldg(owner<uint4, false>(ix, r, o, b) + o);
        ix.far = (ix.remote >> b) & 1u;
        h[0] = row.y;
        h[1] = row.z;
        h[2] = row.w;
        return row.x;
    } else if constexpr (MODE == 4) {
        const uint32_t* w = owner<uint32_t, false>(ix, r, o, b) + 5 * o;
        ix.far = (ix.remote >> b) & 1u;
        const uint32_t lo = __ldg(w), hi = __ldg(w + 1);
        h[0] = __ldg(w + 2);
        h[1] = __ldg(w + 3);
        h[2] = __ldg(w + 4);
        return (long long)(((unsigned long long)hi << 32) | lo);
    } else {
        const RT* sa = owner<RT, false>(ix, r, o, b);
        ix.far = (ix.remote >> b) & 1u;
        if constexpr (MODE == 2) {
            // key2 is by rank: the same block and row, in the same step
            long long ok;
            int bk;
            const uint2 k = __ldg(owner<uint2, true>(ix, r, ok, bk) + ok);
            h[0] = k.x;
            h[1] = k.y;
        }
        const long long pos = (long long)__ldg(sa + o);
        if constexpr (MODE == 3) {
            const uint2 k = __ldg(owner<uint2, true>(ix, pos, o, b) + o);
            ix.far |= ((ix.remote >> b) & 1u) << 1;
            h[0] = k.x;
            h[1] = k.y;
        }
        return pos;
    }
}
#endif

// One lane's compare: (less, lcp) of suffix rank sa_idx against pattern[:v].
// Meets no other lane, so lanes may part ways inside. deep: the steps of
// packed text it read.
template <int MODE, typename RT>
__device__ void cmp_rank(Index<RT>& ix, const Pat& p, int v, long long sa_idx,
                         bool& less, int& lcp, int& deep) {
    constexpr int HB = head_bases<MODE>();
    deep = 0;
    if (sa_idx < 0) { less = true; lcp = 0; return; }
    if (sa_idx >= ix.n_sa) { less = false; lcp = 0; return; }
    uint32_t h[3] = {0u, 0u, 0u};
    const long long pos = load_head<MODE>(ix, sa_idx, h);
    int lh = HB;
    bool lt = false;
    uint32_t x;
    if constexpr (HB > 0) {
        if ((x = h[0] ^ p.k0) != 0u) { lh = lcp16(x); lt = h[0] < p.k0; }
        else if ((x = h[1] ^ p.k1) != 0u) { lh = 16 + lcp16(x); lt = h[1] < p.k1; }
        else if (HB == 48 && (x = h[2] ^ p.k2) != 0u) { lh = 32 + lcp16(x); lt = h[2] < p.k2; }
    }
    const int vc = imin(imax(v, 0), HB);
    if (lh < vc) { less = lt; lcp = lh; return; }
    less = false;
    lcp = vc;
    if (v <= HB) return;
    // ties of the whole head: the packed text, two 64-base segments a step,
    // every word of the step loaded before the first compare. A segment
    // that starts past the text compares as all ones. The first differing
    // base decides, if it lies inside pattern[:v].
    const long long last = ix.n_text_words - 1;
    for (int off = HB, kw = HB / 16;; off += 128, kw += 8) {
        const int nseg = v - off > 64 ? 2 : 1;
        const long long tp = pos + off;
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

// The 32-byte sectors of an entry of `bytes` at rank r of a rank-indexed
// plane; `after`: the lane before probed rank r - 1, whose sectors it
// counted.
__device__ __forceinline__ int rank_sectors(int bytes, long long r,
                                            bool after) {
    const long long first = r * bytes / 32, last = (r * bytes + bytes - 1) / 32;
    const long long prev = (r * bytes - 1) / 32;
    return (int)(last - (after && prev >= first ? prev + 1 : first) + 1);
}

// The warp's probe of one rank a lane (idle lanes: not less, lcp 0), and its
// count of what that read: the rank-indexed entries (consecutive ranks share
// sectors), mode 2's key beside them, mode 3's key at the position; its
// dependent steps: one, two in mode 3 (the key waits for the position), and
// the text's.
template <int MODE, typename RT>
__device__ __forceinline__ void probe(Index<RT>& ix, const Pat& p, int v,
                                      long long rank, bool active,
                                      bool consecutive, bool& less, int& lcp) {
    less = false;
    lcp = 0;
    int deep = 0;
    if (active) cmp_rank<MODE>(ix, p, v, rank, less, lcp, deep);
    if (ix.counting) {
        constexpr int RB = MODE == 4 ? (sizeof(RT) == 4 ? 16 : 20)
                                     : (int)sizeof(RT);
        const bool row = active && rank >= 0 && rank < ix.n_sa;
        const uint32_t rows = __ballot_sync(FULL, row);
        const bool after = consecutive && ix.lane > 0 &&
                           ((rows >> (ix.lane - 1)) & 1u);
        if constexpr (RB == 16) {
            // two rows a sector: an odd rank after its even one shares it.
            // Not rank_sectors: with it narrow round 2 ran up to 23% slower
            // on an H100 even where nothing counts (PERF.md)
            ix.sectors += row && !(after && (rank & 1));
        } else if (row) {
            ix.sectors += rank_sectors(RB, rank, after) +
                          (MODE == 2 ? rank_sectors(8, rank, after) : 0) +
                          (MODE == 3 ? 1 : 0);
        }
        ix.steps += (rows != 0u) * (MODE == 3 ? 2 : 1) +
                    __reduce_max_sync(FULL, deep);
#ifdef SEED_SHARDED
        // a step waits on a remote block if any lane's row (or key) is in
        // one; the text and the leaves are on every card
        ix.remote_steps += __ballot_sync(FULL, row && (ix.far & 1u)) != 0u;
        if constexpr (MODE == 3)
            ix.remote_steps += __ballot_sync(FULL, row && (ix.far & 2u)) != 0u;
#endif
    }
}

// the scalar binary search over [lo, hi], its probes read from the ballot:
// bit k is "go right" of rank first + k
template <typename RT>
__device__ __forceinline__ RT search_bits(uint32_t bits, RT first, RT lo,
                                          RT hi) {
    while (lo < hi) {
        const RT mid = midpoint(lo, hi);
        if ((bits >> (int)(mid - first)) & 1u) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Five levels of the scalar binary search over [lo, hi] in one step: lane k
// (1..31) is node k of the search tree in heap order and probes the mid the
// search would probe on reaching that node; then the walk follows the ballot.
template <int MODE, typename RT>
__device__ void tree_round(Index<RT>& ix, const Pat& p, int v, bool strict,
                           RT& lo, RT& hi) {
    const int lane = ix.lane;
    RT nlo = lo, nhi = hi;
    if (lane > 0)
        for (int d = 30 - __clz(lane); d >= 0 && nlo < nhi; --d) {
            const RT mid = midpoint(nlo, nhi);
            if ((lane >> d) & 1) nlo = mid + 1; else nhi = mid;
        }
    const bool alive = lane > 0 && nlo < nhi;
    bool less;
    int lcp;
    probe<MODE>(ix, p, v, midpoint(nlo, nhi), alive, false, less, lcp);
    const uint32_t bits =
        __ballot_sync(FULL, alive && (less || (strict && lcp >= v)));
    for (int node = 1, d = 0; d < 5 && lo < hi; ++d) {
        const RT mid = midpoint(lo, hi);
        const uint32_t b = (bits >> node) & 1u;
        if (b) lo = mid + 1; else hi = mid;
        node = 2 * node + (int)b;
    }
}

// What the lanes hold after a probe of consecutive ranks: lane k the lcp of
// rank first + k against the pattern, for k < n (0 past both ends of the
// suffix array, and in the lanes past n).
template <typename RT> struct Lanes {
    RT first;
    int n;
    int lcp;
};

// first rank in [lo, hi] whose suffix is >= pattern[:v] (> when strict), as
// the scalar binary search finds it; the last step probes ranks lo - margin
// .. hi + margin - 1 and leaves their lcps in the lanes
template <int MODE, typename RT>
__device__ RT lower_bound(Index<RT>& ix, const Pat& p, int v, RT lo, RT hi,
                          bool strict, int margin, Lanes<RT>& L) {
    while (hi - lo > WARP - 2 * margin)
        tree_round<MODE>(ix, p, v, strict, lo, hi);
    L.first = lo - margin;
    L.n = (int)(hi - lo) + 2 * margin;
    const bool active = ix.lane < L.n;
    bool less;
    probe<MODE>(ix, p, v, (long long)L.first + ix.lane, active, true, less,
                L.lcp);
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
template <typename RT> struct Probed {
    Lanes<RT> lanes;
    RT anchor;
    bool held;
};

// longest match of pattern[:v] over the suffix array (key padded with ones)
template <int MODE, typename RT, bool KMER>
__device__ int find_longest(Index<RT>& ix, const Pat& p, int v,
                            Probed<RT>& P) {
    uint32_t mh, ml;
    keep_masks(v, mh, ml);
    const uint32_t kh = (p.k0 & mh) | ~mh, kl = (p.k1 & ml) | ~ml;
    RT wlo, whi;
    root_window<KMER>(ix, load_root<KMER>(ix, kh), kh, kl, wlo, whi);
    ix.steps += 1;
    const RT ip = lower_bound<MODE>(ix, p, v, wlo, whi, false, 2, P.lanes);
    const int l0 =
        __shfl_sync(FULL, P.lanes.lcp, (int)(ip - 1 - P.lanes.first));
    const int l1 = __shfl_sync(FULL, P.lanes.lcp, (int)(ip - P.lanes.first));
    P.anchor = l0 >= l1 ? ip - 1 : ip;
    P.held = true;
    return imax(l0, l1);
}

// Interval of pattern[:l] by two searches (zeros pad the lower key, ones the
// upper), and b0, b1: the lcps of the ranks that border it, lb - 1 and
// lb + cnt. Both roots (two leaf records, or the four table entries m_a,
// m_a + 1, m_t, m_t + 1) are loaded together; two windows of at most 14
// ranks are searched in one step, half a warp each.
template <int MODE, typename RT, bool KMER>
__device__ void interval_at(Index<RT>& ix, const Pat& p, int l, RT& lb,
                            RT& cnt, int& b0, int& b1) {
    uint32_t mh, ml;
    keep_masks(l, mh, ml);
    const uint32_t ah = p.k0 & mh, al = p.k1 & ml;
    const Leaf ra = load_root<KMER>(ix, ah),
               rb = load_root<KMER>(ix, ah | ~mh);
    RT alo, ahi, blo, bhi, ub;
    root_window<KMER>(ix, ra, ah, al, alo, ahi);
    root_window<KMER>(ix, rb, ah | ~mh, al | ~ml, blo, bhi);
    ix.steps += 1;
    constexpr int HALF = WARP / 2;
    if (ahi - alo <= HALF - 2 && bhi - blo <= HALF - 2) {
        const bool upper = ix.lane >= HALF;
        const int k = ix.lane & (HALF - 1);
        const bool active = k < (int)(upper ? bhi - blo : ahi - alo) + 2;
        bool less;
        int lcp;
        probe<MODE>(ix, p, l, (long long)(upper ? blo : alo) - 1 + k, active,
                    true, less, lcp);
        const uint32_t bits = __ballot_sync(
            FULL, active && (less || (upper && lcp >= l)));
        lb = search_bits(bits & 0xFFFFu, alo - 1, alo, ahi);
        ub = search_bits(bits >> HALF, blo - 1, blo, bhi);
        b0 = __shfl_sync(FULL, lcp, (int)(lb - alo));
        b1 = __shfl_sync(FULL, lcp, HALF + (int)(ub - blo) + 1);
    } else {
        Lanes<RT> L;
        lb = lower_bound<MODE>(ix, p, l, alo, ahi, false, 1, L);
        b0 = __shfl_sync(FULL, L.lcp, (int)(lb - 1 - L.first));
        ub = lower_bound<MODE>(ix, p, l, blo, bhi, true, 1, L);
        b1 = __shfl_sync(FULL, L.lcp, (int)(ub - L.first));
    }
    cnt = ub - lb;
}

// The same out of the lanes, with no load, where they show it: the run of
// lanes around the anchor whose lcp is at least l, if a probed rank with a
// smaller lcp closes it on both sides. l is at most the longest match.
template <typename RT>
__device__ bool lanes_interval(const Probed<RT>& P, int l, RT& lb, RT& cnt,
                               int& b0, int& b1) {
    const Lanes<RT>& L = P.lanes;
    const uint32_t probed = L.n >= WARP ? FULL : (1u << L.n) - 1u;
    const uint32_t shorter = ~__ballot_sync(FULL, L.lcp >= l) & probed;
    const int a = (int)(P.anchor - L.first);  // 1..30
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
template <int MODE, typename RT, bool KMER>
__device__ void interval_level(Index<RT>& ix, const Pat& p, Probed<RT>& P,
                               int l, RT& lb, RT& cnt, int& b0, int& b1) {
    if (P.held && lanes_interval(P, l, lb, cnt, b0, b1)) return;
    P.held = false;
    interval_at<MODE, RT, KMER>(ix, p, l, lb, cnt, b0, b1);
}

// the widening fixed point: longest l whose interval holds >= min_intv
template <int MODE, typename RT, bool KMER>
__device__ void sa_query(Index<RT>& ix, const Pat& p, int v, RT min_intv,
                         int& mlen, RT& lb, RT& cnt) {
    Probed<RT> P;
    mlen = v <= 0 ? 0 : find_longest<MODE, RT, KMER>(ix, p, v, P);
    for (;;) {
        if (mlen == 0) { lb = 0; cnt = ix.n_sa; return; }
        int b0, b1;
        interval_level<MODE, RT, KMER>(ix, p, P, mlen, lb, cnt, b0, b1);
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
// (R, M), int32 or, over a wide index, int64; an emission past slot M is
// counted in dropped, never lost silently. Every lane keeps the counts, lane
// 0 writes.
template <typename RT> struct Slots {
    RT* base;
    long long plane;  // R * M
    int M;
    int n;
    int dropped;
    bool writer;
};

template <typename RT>
__device__ __forceinline__ void emit(Slots<RT>& s, int start, int end, RT lb,
                                     RT cnt) {
    if (s.n < s.M) {
        if (s.writer) {
            RT* q = s.base + s.n;
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
// the sectors and the dependent steps the warp counted of itself; in a
// sharded variant (3, n), the third row the steps that waited on a block on
// another card.
template <typename RT>
__device__ __forceinline__ bool warp_job(Index<RT>& ix, int n,
                                         const int32_t* counts, int& i) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    i = t / WARP;
    ix.lane = t % WARP;
    ix.counting = counts != nullptr;
    ix.sectors = ix.steps = 0;
#ifdef SEED_SHARDED
    ix.remote_steps = 0;
    ix.far = 0u;
#endif
    return i < n;
}

template <typename RT>
__device__ __forceinline__ void finish(const Slots<RT>& s, int i,
                                       int32_t* nsm, int32_t* dropped) {
    if (s.writer) {
        nsm[i] = s.n;
        dropped[i] = s.dropped;
    }
}

template <typename RT>
__device__ __forceinline__ void write_counts(const Index<RT>& ix,
                                             int32_t* counts, int n, int i) {
    if (!counts) return;
    const int sectors = __reduce_add_sync(FULL, ix.sectors);
    if (ix.lane == 0) {
        counts[i] = sectors;
        counts[n + i] = ix.steps;
#ifdef SEED_SHARDED
        counts[2 * n + i] = ix.remote_steps;
#endif
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
template <int MODE, typename RT, bool KMER>
__global__ void __launch_bounds__(READ_THREADS, READ_BLOCKS)
seed_round1_kernel(Index<RT> ixp, const uint32_t* qbuf, int W, Tables tb,
                   const int32_t* lens, int R, int minseed, int M, RT* slots,
                   int32_t* nsm, int32_t* dropped, int32_t* counts) {
    Index<RT> ix = ixp;
    load_blocks(ix);
    int i;
    if (!warp_job(ix, R, counts, i)) return;
    const int l = lens[i];
    const int32_t* nf = tb.nf + (long long)i * tb.Lp;
    const int32_t* nr = tb.nr + (long long)i * tb.Lp;
    const int32_t* nvf = tb.nvf + (long long)i * tb.Lp;
    Slots<RT> s{slots + (long long)i * M, (long long)R * M, M, 0, 0,
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
        int mlen;
        RT lb, cnt;
        sa_query<MODE, RT, KMER>(ix, pat, v, first_interval<RT>(), mlen, lb,
                                 cnt);
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
template <int MODE, typename RT, bool KMER>
__global__ void __launch_bounds__(READ_THREADS, ROUND2_BLOCKS)
seed_round2_kernel(Index<RT> ixp, const uint32_t* qbuf, int W, Tables tb,
                   const int32_t* lens, int R, const RT* slots1,
                   const int32_t* nsm1, int M1, int split_len,
                   int split_width, int minseed, int M, RT* slots,
                   int32_t* nsm, int32_t* dropped, int32_t* counts) {
    Index<RT> ix = ixp;
    load_blocks(ix);
    int i;
    if (!warp_job(ix, R, counts, i)) return;
    const int l = lens[i];
    const int32_t* nf = tb.nf + (long long)i * tb.Lp;
    const int32_t* nr = tb.nr + (long long)i * tb.Lp;
    const long long plane1 = (long long)R * M1;
    const RT* s1 = slots1 + (long long)i * M1;
    Slots<RT> s{slots + (long long)i * M, (long long)R * M, M, 0, 0,
                ix.lane == 0};
    const int n1 = nsm1[i];
    int mlen;
    RT lb, cnt;
    for (int k = 0; k < n1; ++k) {
        const int st = (int)s1[k], en = (int)s1[plane1 + k];
        const RT cn = s1[3 * plane1 + k];
        if (en - st < split_len || cn > split_width) continue;
        const int piv = (st + en) >> 1;
        if (tab(nf, tb.Lp, piv) == piv) continue;  // an N at the pivot
        const RT mi = cn + 1;
        const bool prev_valid = piv > 0 && tab(nf, tb.Lp, piv - 1) != piv - 1;
        sa_query<MODE, RT, KMER>(ix, make_pat(qbuf, W, i, piv),
                                 tab(nf, tb.Lp, piv) - piv, mi, mlen, lb,
                                 cnt);
        if (!prev_valid) {
            if (mlen >= minseed) emit(s, piv, piv + mlen, lb, cnt);
            continue;
        }
        const int npv = piv + mlen;
        int p = piv, psp = piv;
        while (p < npv) {
            const int lp = l - 1 - p;
            sa_query<MODE, RT, KMER>(ix, make_pat(qbuf, W, R + i, lp),
                                     tab(nr, tb.Lp, lp) - lp, mi, mlen, lb,
                                     cnt);
            p = p - mlen + 1;
            if (npv - p < minseed) break;
            sa_query<MODE, RT, KMER>(ix, make_pat(qbuf, W, i, p),
                                     tab(nf, tb.Lp, p) - p, mi, mlen, lb,
                                     cnt);
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
template <int MODE, typename RT, bool KMER>
__global__ void __launch_bounds__(READ_THREADS, READ_BLOCKS)
seed_round3_kernel(Index<RT> ixp, const uint32_t* qbuf, int W, Tables tb,
                   const int32_t* lens, int R, int min_intv, int min_seed,
                   int M, RT* slots, int32_t* nsm, int32_t* dropped,
                   int32_t* counts) {
    Index<RT> ix = ixp;
    load_blocks(ix);
    int i;
    if (!warp_job(ix, R, counts, i)) return;
    const int lim = lens[i] - min_seed + 1;
    const int32_t* nf = tb.nf + (long long)i * tb.Lp;
    Slots<RT> s{slots + (long long)i * M, (long long)R * M, M, 0, 0,
                ix.lane == 0};
    int pv = 0;
    while (pv < lim) {
        const int v = tab(nf, tb.Lp, pv) - pv;
        if (v < min_seed) { pv += imax(v, 1); continue; }  // N, short window
        const Pat pat = make_pat(qbuf, W, i, pv);
        Probed<RT> P;
        const int lmax = find_longest<MODE, RT, KMER>(ix, pat, v, P);
        if (lmax < min_seed) { pv += imax(min_seed, 1); continue; }
        int cur_l = lmax, b0, b1, advance;
        RT lb, cnt, prev_lb = 0, prev_cnt = 0;
        interval_level<MODE, RT, KMER>(ix, pat, P, cur_l, lb, cnt, b0, b1);
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
            interval_level<MODE, RT, KMER>(ix, pat, P, cur_l, lb, cnt, b0,
                                           b1);
        }
        pv += imax(advance, 1);
    }
    finish(s, i, nsm, dropped);
    write_counts(ix, counts, R, i);
}

// the primitives alone, to hold them against their plain versions on the
// card: a window is one root a key, so a thread a key (the same for every
// mode: a variant a width and a root); sa_query a warp a job
template <typename RT, bool KMER>
__global__ void window_kernel(Index<RT> ix, const uint32_t* khi,
                              const uint32_t* klo, int n, RT* lo, RT* hi) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    RT a, b;
    root_window<KMER>(ix, load_root<KMER>(ix, khi[i]), khi[i], klo[i], a, b);
    lo[i] = a;
    hi[i] = b;
}

template <int MODE, typename RT, bool KMER>
__global__ void __launch_bounds__(READ_THREADS, READ_BLOCKS)
sa_query_kernel(Index<RT> ixp, const uint32_t* qbuf, int W,
                const int32_t* row, const int32_t* pivot, const int32_t* v,
                const int32_t* min_intv, int n, RT* out, int32_t* counts) {
    Index<RT> ix = ixp;
    load_blocks(ix);
    int i;
    if (!warp_job(ix, n, counts, i)) return;
    int mlen;
    RT lb, cnt;
    sa_query<MODE, RT, KMER>(ix, make_pat(qbuf, W, row[i], pivot[i]), v[i],
                             (RT)min_intv[i], mlen, lb, cnt);
    if (ix.lane == 0) {
        out[i] = mlen;
        out[n + i] = lb;
        out[2 * n + i] = cnt;
    }
    write_counts(ix, counts, n, i);
}

// ------------------------------------------------------------- launchers

// The index as every launcher takes it: the mode's planes (those it does
// not have are null), the packed text, the leaf records, with wide set the
// int64 leaf starts, and for the ERT root the k-mer table (null and 0
// otherwise); n_sa as int64.
struct IndexArgs {
    const void* rk;
    const void* sa;
    const void* keys;
    const void* text32;
    long long n_text_words;
    const void* params;
    const void* params64;
    int n_leaf;
    int bits;
    long long n_sa;
    const void* kmer_table;
    int kmer_bits;
#ifdef SEED_SHARDED
    // rk, sa and keys are the block tables; the rows a block, its
    // reciprocal (Index::recip), the blocks, the remote ones' bits
    long long block_rows;
    unsigned long long recip;
    int n_blocks;
    unsigned remote;
#endif
};

#ifndef SEED_SHARDED
template <typename RT> static Index<RT> make_index(const IndexArgs& a) {
    return Index<RT>{(const uint32_t*)a.rk, (const RT*)a.sa,
                     (const uint2*)a.keys, (const uint32_t*)a.text32,
                     a.n_text_words, (const uint32_t*)a.params,
                     (const long long*)a.params64, a.n_leaf, a.bits,
                     (RT)a.n_sa, (const RT*)a.kmer_table, a.kmer_bits, 0,
                     false, 0, 0};
}
#else
template <typename RT> static Index<RT> make_index(const IndexArgs& a) {
    return Index<RT>{nullptr, nullptr, nullptr, (const uint32_t*)a.text32,
                     a.n_text_words, (const uint32_t*)a.params,
                     (const long long*)a.params64, a.n_leaf, a.bits,
                     (RT)a.n_sa, (const RT*)a.kmer_table, a.kmer_bits, 0,
                     false, 0, 0,
                     (const long long*)(a.rk ? a.rk : a.sa),
                     (const long long*)a.keys, (RT)a.block_rows, a.recip,
                     a.n_blocks, a.remote, 0u, 0};
}
#endif

static const int KEY_THREADS = 128;

// blocks of n warps' jobs
static int warp_blocks(int n) {
    const int per_block = READ_THREADS / WARP;
    return (n + per_block - 1) / per_block;
}

template <int MODE, typename RT, bool KMER>
static int round1(const IndexArgs& ia, const void* qbuf, int W, Tables tb,
                  const void* lens, int R, int minseed, int M, void* slots,
                  void* nsm, void* dropped, void* counts, void* stream) {
    seed_round1_kernel<MODE, RT, KMER><<<warp_blocks(R), READ_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        make_index<RT>(ia), (const uint32_t*)qbuf, W, tb,
        (const int32_t*)lens, R, minseed, M, (RT*)slots, (int32_t*)nsm,
        (int32_t*)dropped, (int32_t*)counts);
    return (int)cudaGetLastError();
}

template <int MODE, typename RT, bool KMER>
static int round2(const IndexArgs& ia, const void* qbuf, int W, Tables tb,
                  const void* lens, int R, const void* slots1,
                  const void* nsm1, int M1, int split_len, int split_width,
                  int minseed, int M, void* slots, void* nsm, void* dropped,
                  void* counts, void* stream) {
    seed_round2_kernel<MODE, RT, KMER><<<warp_blocks(R), READ_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        make_index<RT>(ia), (const uint32_t*)qbuf, W, tb,
        (const int32_t*)lens, R, (const RT*)slots1, (const int32_t*)nsm1, M1,
        split_len, split_width, minseed, M, (RT*)slots, (int32_t*)nsm,
        (int32_t*)dropped, (int32_t*)counts);
    return (int)cudaGetLastError();
}

template <int MODE, typename RT, bool KMER>
static int round3(const IndexArgs& ia, const void* qbuf, int W, Tables tb,
                  const void* lens, int R, int min_intv, int min_seed, int M,
                  void* slots, void* nsm, void* dropped, void* counts,
                  void* stream) {
    seed_round3_kernel<MODE, RT, KMER><<<warp_blocks(R), READ_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        make_index<RT>(ia), (const uint32_t*)qbuf, W, tb,
        (const int32_t*)lens, R, min_intv, min_seed, M, (RT*)slots,
        (int32_t*)nsm, (int32_t*)dropped, (int32_t*)counts);
    return (int)cudaGetLastError();
}

template <typename RT, bool KMER>
static int window(const IndexArgs& ia, const void* khi, const void* klo,
                  int n, void* lo, void* hi, void* stream) {
    window_kernel<RT, KMER><<<(n + KEY_THREADS - 1) / KEY_THREADS,
                             KEY_THREADS, 0, (cudaStream_t)stream>>>(
        make_index<RT>(ia), (const uint32_t*)khi, (const uint32_t*)klo, n,
        (RT*)lo, (RT*)hi);
    return (int)cudaGetLastError();
}

template <int MODE, typename RT, bool KMER>
static int query(const IndexArgs& ia, const void* qbuf, int W,
                 const void* row, const void* pivot, const void* v,
                 const void* min_intv, int n, void* out, void* counts,
                 void* stream) {
    sa_query_kernel<MODE, RT, KMER><<<warp_blocks(n), READ_THREADS, 0,
                                (cudaStream_t)stream>>>(
        make_index<RT>(ia), (const uint32_t*)qbuf, W, (const int32_t*)row,
        (const int32_t*)pivot, (const int32_t*)v, (const int32_t*)min_intv,
        n, (RT*)out, (int32_t*)counts);
    return (int)cudaGetLastError();
}

// F<MODE, RT, KMER>(...) of the layout's variant; cudaErrorInvalidValue for a
// mode outside 1..4 or a variant this build leaves out. Built with SEED_MODE
// and SEED_ROOT set (0: the P-RMI, 1: the k-mer root), the library holds that
// mode's two widths of that root alone (ops/build.py builds a library a mode
// and a root, side by side); without them, all sixteen.
#if !defined(SEED_ROOT) || SEED_ROOT == 0
#define ROOT_P(M, F, ...)                                                   \
    case 4 * M: return F<M, int, false>(__VA_ARGS__);                       \
    case 4 * M + 2: return F<M, long long, false>(__VA_ARGS__);
#else
#define ROOT_P(M, F, ...)
#endif
#if !defined(SEED_ROOT) || SEED_ROOT == 1
#define ROOT_K(M, F, ...)                                                   \
    case 4 * M + 1: return F<M, int, true>(__VA_ARGS__);                    \
    case 4 * M + 3: return F<M, long long, true>(__VA_ARGS__);
#else
#define ROOT_K(M, F, ...)
#endif
#define CASES(M, F, ...) ROOT_P(M, F, __VA_ARGS__) ROOT_K(M, F, __VA_ARGS__)
#if !defined(SEED_MODE) || SEED_MODE == 1
#define CASES_1(F, ...) CASES(1, F, __VA_ARGS__)
#else
#define CASES_1(F, ...)
#endif
#if !defined(SEED_MODE) || SEED_MODE == 2
#define CASES_2(F, ...) CASES(2, F, __VA_ARGS__)
#else
#define CASES_2(F, ...)
#endif
#if !defined(SEED_MODE) || SEED_MODE == 3
#define CASES_3(F, ...) CASES(3, F, __VA_ARGS__)
#else
#define CASES_3(F, ...)
#endif
#if !defined(SEED_MODE) || SEED_MODE == 4
#define CASES_4(F, ...) CASES(4, F, __VA_ARGS__)
#else
#define CASES_4(F, ...)
#endif
#define VARIANT(F, ...)                                                     \
    switch (mode * 4 + (wide != 0) * 2 + (kmer_bits > 0)) {                 \
        CASES_1(F, __VA_ARGS__)                                             \
        CASES_2(F, __VA_ARGS__)                                             \
        CASES_3(F, __VA_ARGS__)                                             \
        CASES_4(F, __VA_ARGS__)                                             \
        default: return (int)cudaErrorInvalidValue;                         \
    }

#ifndef SEED_SHARDED
#define INDEX_PARAMS                                                        \
    int mode, int wide, const void *rk, const void *sa, const void *keys,  \
        const void *text32, long long n_text_words, const void *params,    \
        const void *params64, int n_leaf, int bits, long long n_sa,        \
        const void *kmer_table, int kmer_bits
#define INDEX_ARGS                                                          \
    IndexArgs { rk, sa, keys, text32, n_text_words, params, params64,      \
                n_leaf, bits, n_sa, kmer_table, kmer_bits }
#else
// rk, sa and keys are the planes' block tables
#define INDEX_PARAMS                                                        \
    int mode, int wide, const void *rk, const void *sa, const void *keys,  \
        const void *text32, long long n_text_words, const void *params,    \
        const void *params64, int n_leaf, int bits, long long n_sa,        \
        const void *kmer_table, int kmer_bits, long long block_rows,       \
        unsigned long long recip, int n_blocks, unsigned remote
#define INDEX_ARGS                                                          \
    IndexArgs { rk, sa, keys, text32, n_text_words, params, params64,      \
                n_leaf, bits, n_sa, kmer_table, kmer_bits, block_rows,     \
                recip, n_blocks, remote }
// the block list the shared-memory copy holds
#define CHECK_BLOCKS                                                        \
    if (n_blocks < 1 || n_blocks > MAX_BLOCKS || block_rows < 1)           \
        return (int)cudaErrorInvalidValue;
#endif
#ifndef SEED_SHARDED
#define CHECK_BLOCKS
#endif

extern "C" {

int seed_round1_launch(INDEX_PARAMS, const void* qbuf, int W, const void* nf,
                       const void* nr, const void* nvf, int Lp,
                       const void* lens, int R, int minseed, int M,
                       void* slots, void* nsm, void* dropped, void* counts,
                       void* stream) {
    if (R == 0) return 0;
    CHECK_BLOCKS
    const Tables tb{(const int32_t*)nf, (const int32_t*)nr,
                    (const int32_t*)nvf, Lp};
    VARIANT(round1, INDEX_ARGS, qbuf, W, tb, lens, R, minseed, M, slots, nsm,
            dropped, counts, stream)
}

int seed_round2_launch(INDEX_PARAMS, const void* qbuf, int W, const void* nf,
                       const void* nr, int Lp, const void* lens, int R,
                       const void* slots1, const void* nsm1, int M1,
                       int split_len, int split_width, int minseed, int M,
                       void* slots, void* nsm, void* dropped, void* counts,
                       void* stream) {
    if (R == 0) return 0;
    CHECK_BLOCKS
    const Tables tb{(const int32_t*)nf, (const int32_t*)nr, nullptr, Lp};
    VARIANT(round2, INDEX_ARGS, qbuf, W, tb, lens, R, slots1, nsm1, M1,
            split_len, split_width, minseed, M, slots, nsm, dropped, counts,
            stream)
}

int seed_round3_launch(INDEX_PARAMS, const void* qbuf, int W, const void* nf,
                       int Lp, const void* lens, int R, int min_intv,
                       int min_seed, int M, void* slots, void* nsm,
                       void* dropped, void* counts, void* stream) {
    if (R == 0) return 0;
    CHECK_BLOCKS
    const Tables tb{(const int32_t*)nf, nullptr, nullptr, Lp};
    VARIANT(round3, INDEX_ARGS, qbuf, W, tb, lens, R, min_intv, min_seed, M,
            slots, nsm, dropped, counts, stream)
}

#ifndef SEED_SHARDED
// the window of the index's root (prmi_window, or kmer_window with
// kmer_bits > 0), the same code in every mode; it reads no per-suffix
// plane, so a sharded index takes it from the whole index's library
int window_launch(INDEX_PARAMS, const void* khi, const void* klo, int n,
                  void* lo, void* hi, void* stream) {
    if (n == 0) return 0;
    if (mode < 1 || mode > 4) return (int)cudaErrorInvalidValue;
#if !defined(SEED_ROOT) || SEED_ROOT == 1
    if (kmer_bits > 0)
        return wide ? window<long long, true>(INDEX_ARGS, khi, klo, n, lo, hi,
                                              stream)
                    : window<int, true>(INDEX_ARGS, khi, klo, n, lo, hi,
                                        stream);
#endif
#if !defined(SEED_ROOT) || SEED_ROOT == 0
    if (kmer_bits == 0)
        return wide ? window<long long, false>(INDEX_ARGS, khi, klo, n, lo,
                                               hi, stream)
                    : window<int, false>(INDEX_ARGS, khi, klo, n, lo, hi,
                                         stream);
#endif
    return (int)cudaErrorInvalidValue;
}
#endif

int sa_query_launch(INDEX_PARAMS, const void* qbuf, int W, const void* row,
                    const void* pivot, const void* v, const void* min_intv,
                    int n, void* out, void* counts, void* stream) {
    if (n == 0) return 0;
    CHECK_BLOCKS
    VARIANT(query, INDEX_ARGS, qbuf, W, row, pivot, v, min_intv, n, out,
            counts, stream)
}

#ifdef SEED_SHARDED
// lets card `device` read the memory of card `peer` (once a pair: an
// enabled pair is no error); the current card is left as it was
int enable_peer_access(int device, int peer) {
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err == cudaSuccess) {
        err = cudaDeviceEnablePeerAccess(peer, 0);
        if (err == cudaErrorPeerAccessAlreadyEnabled) {
            cudaGetLastError();
            err = cudaSuccess;
        }
        const cudaError_t back = cudaSetDevice(prev);
        if (err == cudaSuccess) err = back;
    }
    return (int)err;
}
#endif

}  // extern "C"
