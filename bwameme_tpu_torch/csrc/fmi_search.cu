// FM-index seeding for Hopper (sm_90a): the bidirectional extension, the
// compressed suffix-array lookup and the SMEM search of a read, run to its
// end on the card.
//
// Replaces the XLA programs of bwameme_tpu/ops/fmi_search.py (occ :120,
// backward_ext_all :133, backward_ext :150, forward_ext :156, init_intv :160,
// sa_lookup :167) and the host-driven waves that bwameme_tpu/seeding/
// fmi_engine.py runs them in (FmiDeviceEngine._run_machines :265, the rounds
// :401-465). On the TPU a batch's SMEM state machines live on the host and
// every wave of extensions is one device call; here a warp runs one read's
// machines to their end in FmiHostEngine's order (seeding/fmi_engine.py:
// _one_pos :62, _bwt_seed_strategy :129, collect_smems :155): round 1 pivot
// by pivot, round 2 reseed job by job over round 1's emissions, round 3.
// Emissions keep that order; the engine's pack sorts them stably by (read,
// start, end).
//
// The index is int32 throughout, as in the JAX package (its text, forward +
// reverse complement + sentinel, is below 2^31 bases; ops/fmi_search.py
// checks it). A 64-base block of the BWT is one 32-byte record, one sector:
// the occ of the four bases at the block's start (four int32), then the
// block's 64 codes as two 64-bit bit planes, H the high bit of each code
// and L the low bit, bit o for the block's base o. The sentinel has no
// base: its slot holds code 0, and occ(0, p) takes it out again when it
// lies in [64 blk, p); the LF walk finds it by p == sentinel, a compare
// with no load. occ(b, p) is the record's count of b plus the popcount of
// b's match plane (H & L for 3, H & ~L for 2, ~H & L for 1, ~(H | L) for
// 0) under the block's first p & 63 bases. A record is two 16-byte loads
// of one sector, issued together; an extension needs the records of k and
// of k + s, one when they are one block, so it is one dependent step.
//
// What bounds fmi_smem on this card is not bytes (a 4096-read batch stands
// on some 33 MB of occ blocks, 0.010 ms at 3.35 TB/s) but the slowest read's
// chain of dependent occ loads, 0.5 us each, and on a full card the work an
// SM does a step for its warps (on an H100, a 4096-read batch at 100 Mbp
// takes 1.9x its slowest read alone, 2.5x with an occ block in two arrays,
// three loads on two lines). A thread a read made every extension
// a step of that chain, the backward pass's too, and a warp ran the union
// of its 32 reads' branches. So the design is a warp a read, four reads a
// block (a 4096-read batch is 1024 blocks over all 132 SMs):
// * The forward passes and round 3 are one chain that every lane runs with
//   the same values: the loads are broadcasts, no lane diverges, lane 0
//   writes. A warp whose read does not exist leaves as a whole, so every
//   warp primitive is met by all 32 lanes.
// * A backward step extends the entries of the list in flight (the prev of
//   _one_pos, at most one a base of the read) across the lanes, 32 a
//   dependent step, and reduces the host loop to ballots and prefix counts,
//   with no assumption on the order of the counts: the step's first event
//   (the first survivor, or the first entry that dies long enough to be an
//   SMEM) is the lowest bit of a ballot, and it emits the old interval when
//   it is not a survivor; a survivor is kept iff its count differs from the
//   nearest survivor's before it (-1 for none: after the host loop handles
//   a survivor, curr_s is its count, kept or not), found by a masked ballot
//   and a shuffle, the last one carried from chunk to chunk; a kept entry's
//   place is the popcount of the kept ballot below its lane plus the count
//   carried. The new list is written over the old one: a chunk's writes
//   land at or below its reads and below every later chunk's.
// * The list lives in global scratch, (L + 1) entries of 16 bytes a read
//   for a batch whose longest read is L: its loads are a chunk's, one
//   16-byte entry a lane, and stay in L1 and L2 (a list in the block's
//   shared memory ran no faster at 151 bases and 3.7% slower at 1 kbp on
//   an H100, PERF.md). An entry is (k, l, s, n): every entry of a list
//   starts at the same base, which the warp keeps as a scalar. The forward
//   pass writes its entries from the top down, so that they read longest
//   first from where the last one landed, with no reversal.
// An emission past slot M is counted, not written: the wrapper reruns such
// a read with room for all of them.

#include <cstdint>
#include <cuda_runtime.h>

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int SA_COMPX = 3;
constexpr int SA_COMPX_MASK = (1 << SA_COMPX) - 1;
constexpr int THREADS = 128;

struct Fmi {
    const int4* occ;        // (nb, 2) a block's record: counts, (H, L)
    const int32_t* sa_comp; // ((n >> 3) + 1) every 8th suffix position
    int count[5];           // first rank of each base, count[4] = n + 1
    int nb;
    int sentinel;
};

// a block's record in registers
struct Blk {
    int4 c;          // occ of bases 0-3 at the block's start
    uint64_t h, l;   // the high and the low bit planes of its codes
};

// the block of rank p, 0 <= p <= n + 1
__device__ __forceinline__ int block_of(const Fmi& f, int p) {
    const int blk = p >> 6;
    return blk < f.nb - 1 ? blk : f.nb - 1;
}

// both halves of a record, one sector, issued back to back
__device__ __forceinline__ Blk load_block(const Fmi& f, int blk) {
    const int4 c = __ldg(f.occ + 2 * blk);
    const int4 w = __ldg(f.occ + 2 * blk + 1);
    return Blk{c, (uint64_t)(uint32_t)w.y << 32 | (uint32_t)w.x,
               (uint64_t)(uint32_t)w.w << 32 | (uint32_t)w.z};
}

// v[a] of four values, a select chain (no local array)
__device__ __forceinline__ int pick(int a, int v0, int v1, int v2, int v3) {
    return a == 0 ? v0 : a == 1 ? v1 : a == 2 ? v2 : v3;
}

// the bases under p & 63 in its block
__device__ __forceinline__ uint64_t below(int p) {
    return (1ull << (p & 63)) - 1ull;
}

// occ(a, p) from p's record x of block blk; the sentinel's slot, code 0, is
// no base
__device__ __forceinline__ int occ_at(const Fmi& f, const Blk& x, int blk,
                                      int p, int a) {
    const uint64_t m = ((a & 2) ? x.h : ~x.h) & ((a & 1) ? x.l : ~x.l);
    const int sent = (a == 0 && p > f.sentinel && f.sentinel >= blk << 6);
    return pick(a, x.c.x, x.c.y, x.c.z, x.c.w) + __popcll(m & below(p))
           - sent;
}

// the bases greater than a in bwt[0:p), from p's record x
__device__ __forceinline__ int occ_above(const Blk& x, int p, int a) {
    const uint64_t m = a == 0 ? x.h | x.l : a == 1 ? x.h : a == 2 ? x.h & x.l
                                                                  : 0ull;
    return pick(a, x.c.y + x.c.z + x.c.w, x.c.z + x.c.w, x.c.w, 0)
           + __popcll(m & below(p));
}

struct Intv {
    int k, l, s;
};

// backward extension of (k, l, s) by base a, with the sentinel rule for the
// complement side (reference: src/FMI_search.cpp:1039-1067): l of base a's
// child is l, plus the sentinel if it lies in [k, k + s), plus the bases
// greater than a there. Both records' loads are issued before either is
// used, and one is loaded when k and k + s share a block.
__device__ __forceinline__ Intv backward_ext(const Fmi& f, int k, int l,
                                             int s, int a) {
    const int e = k + s;
    const int bk = block_of(f, k), be = block_of(f, e);
    const Blk x = load_block(f, bk);
    Blk y = x;
    if (be != bk) y = load_block(f, be);
    const int ok = occ_at(f, x, bk, k, a);
    const int sent = (k <= f.sentinel && e > f.sentinel) ? 1 : 0;
    Intv r;
    r.k = pick(a, f.count[0], f.count[1], f.count[2], f.count[3]) + ok;
    r.s = occ_at(f, y, be, e, a) - ok;
    r.l = l + sent + occ_above(y, e, a) - occ_above(x, k, a);
    return r;
}

// forward extension = backward extension of the complement, k and l swapped
__device__ __forceinline__ Intv forward_ext(const Fmi& f, const Intv& x,
                                            int a) {
    const Intv r = backward_ext(f, x.l, x.k, x.s, 3 - a);
    return Intv{r.l, r.k, r.s};
}

__device__ __forceinline__ Intv init_intv(const Fmi& f, int a) {
    return Intv{f.count[a], f.count[3 - a], f.count[a + 1] - f.count[a]};
}

// ------------------------------------------------------------ SMEM search

constexpr int LANES = 32;
constexpr int WARPS = THREADS / LANES;  // fmi_smem's reads a block

// A read's view of the launch, the same in every lane of its warp but
// `lane`: its codes, its emission slots, its list of intervals in flight
// and the warp's dependent steps
struct Read {
    const uint8_t* codes;   // min(code, 4)
    int len;
    int* slots;             // start, end, k, s planes of (R, M)
    long long plane;        // R * M
    int M;
    int n;                  // emissions so far (past M counted, not kept)
    int4* list;             // (k, l, s, end) entries, `cap` of them
    int cap;
    int lane;
    int fwd;                // forward extensions (each a dependent step)
    int bwd;                // backward chunks of 32 entries (each a step)
    int bwd_ext;            // backward extensions
};

__device__ __forceinline__ void emit(Read& r, bool writer, int start,
                                     int end, int k, int s) {
    if (writer && r.n < r.M) {
        int* q = r.slots + r.n;
        q[0] = start;
        q[r.plane] = end;
        q[2 * r.plane] = k;
        q[3 * r.plane] = s;
    }
    ++r.n;
}

// One backward step of the np entries at list[base] whose intervals start
// at m, by base a, as _one_pos's two inner loops compute it, 32 entries a
// step (see the note at the top); the new list, at list[0], starts at the
// step's column. Returns its length.
__device__ int backward_step(const Fmi& f, Read& r, int base, int np, int m,
                             int a, int min_intv, int min_seed) {
    const uint32_t below = (1u << r.lane) - 1u;
    int nc = 0, last_s = -1;
    bool open = true;  // no survivor and no emission yet
    for (int c = 0; c < np; c += LANES) {
        const int p = c + r.lane;
        const bool in = p < np;
        int4 e{0, 0, 0, 0};
        Intv nx{0, 0, 0};
        if (in) {
            e = r.list[base + p];
            nx = backward_ext(f, e.x, e.y, e.z, a);
        }
        ++r.bwd;
        r.bwd_ext += np - c < LANES ? np - c : LANES;
        const bool surv = in && nx.s >= min_intv;
        const uint32_t alive = __ballot_sync(FULL, surv);
        if (open) {
            const uint32_t ev = __ballot_sync(
                FULL, surv || (in && e.w - m + 1 >= min_seed));
            if (ev) {
                open = false;
                const int first = __ffs((int)ev) - 1;
                if (!((alive >> first) & 1u))
                    emit(r, r.lane == first, m, e.w + 1, e.x, e.z);
            }
        }
        const uint32_t before = alive & below;
        const int prev_s = __shfl_sync(
            FULL, nx.s, before ? 31 - __clz((int)before) : 0);
        const bool kept = surv && nx.s != (before ? prev_s : last_s);
        const uint32_t keep = __ballot_sync(FULL, kept);
        if (alive) last_s = __shfl_sync(FULL, nx.s, 31 - __clz((int)alive));
        __syncwarp();  // every lane has read its entry
        if (kept)
            r.list[nc + __popc(keep & below)] = int4{nx.k, nx.l, nx.s, e.w};
        nc += __popc(keep);
    }
    __syncwarp();  // the new list, for every lane
    return nc;
}

// one forward/backward SMEM pass from pivot x (FmiHostEngine._one_pos,
// reference FMI_search.cpp:506-683); returns the next pivot
__device__ int one_pos(const Fmi& f, Read& r, int x, int min_intv,
                       int min_seed) {
    const uint8_t* codes = r.codes;
    int a = codes[x];
    int next_x = x + 1;
    if (a >= 4) return next_x;
    Intv cur = init_intv(f, a);
    int n0 = x, base = r.cap;  // the list is list[base, cap), longest first
    for (int j = x + 1; j < r.len; ++j) {
        a = codes[j];
        next_x = j + 1;
        if (a >= 4) break;
        const Intv nx = forward_ext(f, cur, a);
        ++r.fwd;
        if (nx.s != cur.s) {
            --base;
            if (r.lane == 0) r.list[base] = int4{cur.k, cur.l, cur.s, n0};
        }
        if (nx.s < min_intv) {
            next_x = j;  // restart at the failing column
            break;
        }
        cur = nx;
        n0 = j;
    }
    if (cur.s >= min_intv) {
        --base;
        if (r.lane == 0) r.list[base] = int4{cur.k, cur.l, cur.s, n0};
    }
    __syncwarp();  // lane 0's entries, for every lane
    int np = r.cap - base, m = x;
    for (int j = x - 1; j >= 0 && np > 0; --j) {
        a = codes[j];
        if (a >= 4) break;
        np = backward_step(f, r, base, np, m, a, min_intv, min_seed);
        base = 0;
        m = j;
    }
    if (np > 0) {
        const int4 e = r.list[base];
        if (e.w - m + 1 >= min_seed)
            emit(r, r.lane == 0, m, e.w + 1, e.x, e.z);
    }
    __syncwarp();  // every lane has read list[base] before the next pass
    return next_x;
}

// round 3: forward-only sweeps (FmiHostEngine._bwt_seed_strategy,
// reference FMI_search.cpp:738-830), the same chain in every lane
__device__ void seed_strategy(const Fmi& f, Read& r, int max_intv,
                              int min_seed1) {
    const uint8_t* codes = r.codes;
    int x = 0;
    while (x < r.len) {
        int next_x = x + 1;
        int a = codes[x];
        if (a < 4) {
            Intv cur = init_intv(f, a);
            for (int j = x + 1; j < r.len; ++j) {
                next_x = j + 1;
                a = codes[j];
                if (a >= 4) break;
                cur = forward_ext(f, cur, a);
                ++r.fwd;
                if (cur.s < max_intv && j - x + 1 >= min_seed1) {
                    if (cur.s > 0)
                        emit(r, r.lane == 0, x, j + 1, cur.k, cur.s);
                    break;
                }
            }
        }
        x = next_x;
    }
}

struct SmemOpt {
    int min_seed, split_len, split_width, max_mem_intv;
};

// a warp a read; list: (R, L + 1) entries of scratch, a read's intervals in
// flight
__global__ void __launch_bounds__(THREADS)
fmi_smem_kernel(Fmi f, const uint8_t* codes, int L, const int32_t* lens,
                int R, SmemOpt o, int M, int32_t* slots, int32_t* nsm,
                int32_t* list, int32_t* steps) {
    const int w = threadIdx.x / LANES;
    const int i = blockIdx.x * WARPS + w;
    if (i >= R) return;  // the whole warp
    Read r{codes + (long long)i * L, lens[i], slots + (long long)i * M,
           (long long)R * M, M, 0, (int4*)list + (long long)i * (L + 1),
           L + 1, (int)(threadIdx.x % LANES),
           0, 0, 0};
    for (int x = 0; x < r.len;) x = one_pos(f, r, x, 1, o.min_seed);
    // round 2: reseed long, rare round-1 SMEMs at their middle with
    // min_intv = hitcount + 1 (reference: src/bwamem.cpp:760-790); a read
    // whose round 1 outgrew its slots is rerun, so the kept ones suffice
    const int n1 = r.n < M ? r.n : M;
    const long long pl = r.plane;
    for (int e = 0; e < n1; ++e) {
        const int st = r.slots[e], en = r.slots[pl + e];
        const int hits = r.slots[3 * pl + e];
        if (en - st < o.split_len || hits > o.split_width) continue;
        one_pos(f, r, (st + en) >> 1, hits + 1, o.min_seed);
    }
    if (o.max_mem_intv > 0)
        seed_strategy(f, r, o.max_mem_intv, o.min_seed + 1);
    if (r.lane == 0) {
        nsm[i] = r.n;
        if (steps) {
            steps[i] = r.fwd;
            steps[R + i] = r.bwd;
            steps[2 * R + i] = r.bwd_ext;
        }
    }
}

// ---------------------------------------------------- the primitives alone

// a thread a unit: the child of (k, l, s) by base a
__global__ void fmi_backward_ext_kernel(Fmi f, const int32_t* k,
                                        const int32_t* l, const int32_t* s,
                                        const int32_t* a, int n,
                                        int32_t* out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Intv r = backward_ext(f, k[i], l[i], s[i], a[i]);
    out[i] = r.k;
    out[n + i] = r.l;
    out[2 * n + i] = r.s;
}

// a thread a rank: LF-walk to a stored entry of the compressed suffix array
// or to the sentinel (reference: src/FMI_search.cpp:1117-1180). A step is
// one dependent record load, issued before any branch: the base, the
// sentinel test and occ(b, sp) all come from its registers.
__global__ void fmi_sa_lookup_kernel(Fmi f, const int32_t* rank, int n,
                                     int32_t* pos) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int sp = rank[i], offset = 0;
    while (sp & SA_COMPX_MASK) {
        const int blk = block_of(f, sp);
        const Blk x = load_block(f, blk);
        if (sp == f.sentinel) {
            pos[i] = offset;
            return;
        }
        const int off = sp & 63;
        const int b = (int)((x.h >> off) & 1ull) << 1
                      | (int)((x.l >> off) & 1ull);
        sp = pick(b, f.count[0], f.count[1], f.count[2], f.count[3])
             + occ_at(f, x, blk, sp, b);
        ++offset;
    }
    pos[i] = __ldg(f.sa_comp + (sp >> SA_COMPX)) + offset;
}

// ------------------------------------------------------------- launchers

static Fmi make_fmi(const void* count, const void* occ, const void* sa_comp,
                    int nb, int sentinel) {
    Fmi f;
    f.occ = (const int4*)occ;
    f.sa_comp = (const int32_t*)sa_comp;
    for (int b = 0; b < 5; ++b) f.count[b] = ((const int32_t*)count)[b];
    f.nb = nb;
    f.sentinel = sentinel;
    return f;
}

static int blocks(int n) { return (n + THREADS - 1) / THREADS; }

// count: the five counts on the host (a kernel parameter); occ: the (nb, 8)
// int32 records, 32-byte aligned
#define FMI_PARAMS                                                          \
    const void *count, const void *occ, const void *sa_comp, int nb,       \
        int sentinel
#define FMI_ARGS make_fmi(count, occ, sa_comp, nb, sentinel)

extern "C" {

int fmi_backward_ext_launch(FMI_PARAMS, const void* k, const void* l,
                            const void* s, const void* a, int n, void* out,
                            void* stream) {
    if (n == 0) return 0;
    fmi_backward_ext_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        FMI_ARGS, (const int32_t*)k, (const int32_t*)l, (const int32_t*)s,
        (const int32_t*)a, n, (int32_t*)out);
    return (int)cudaGetLastError();
}

int fmi_sa_lookup_launch(FMI_PARAMS, const void* rank, int n, void* pos,
                         void* stream) {
    if (n == 0) return 0;
    fmi_sa_lookup_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        FMI_ARGS, (const int32_t*)rank, n, (int32_t*)pos);
    return (int)cudaGetLastError();
}

// list: (R, L + 1, 4) int32 scratch
int fmi_smem_launch(FMI_PARAMS, const void* codes, int L, const void* lens,
                    int R, int min_seed, int split_len, int split_width,
                    int max_mem_intv, int M, void* slots, void* nsm,
                    void* list, void* steps, void* stream) {
    if (R == 0) return 0;
    const SmemOpt o{min_seed, split_len, split_width, max_mem_intv};
    const int n_blocks = (R + WARPS - 1) / WARPS;
    fmi_smem_kernel<<<n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
        FMI_ARGS, (const uint8_t*)codes, L, (const int32_t*)lens, R, o, M,
        (int32_t*)slots, (int32_t*)nsm, (int32_t*)list, (int32_t*)steps);
    return (int)cudaGetLastError();
}

}  // extern "C"
