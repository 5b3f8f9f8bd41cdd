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
// checks it). occ(b, p) is the 64-base block's checkpoint count plus the
// popcount of base b's one-hot bitmap under the block's first p & 63 bases,
// most significant bit first: a block is one 16-byte load of its four
// counts and two 16-byte loads of its eight bitmap words, so an extension,
// which needs the blocks of k and k + s, is one dependent step.
//
// What bounds fmi_smem on this card is not bytes (a 4096-read batch stands
// on some 58 MB of occ blocks, 0.018 ms at 3.35 TB/s) but the slowest read's
// chain of dependent occ loads, 0.5 us each, and on a full card how many
// such chains an SM keeps going (on an H100, a 4096-read batch at 100 Mbp
// takes 2.5x its slowest read alone). A thread a read made every extension
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
    const int4* cp_count;   // (nb) occ of the four bases at block starts
    const uint4* cp_bits;   // (nb, 2) words (base, word) of a block's bitmaps
    const int32_t* sa_comp; // ((n >> 3) + 1) every 8th suffix position
    int count[5];           // first rank of each base, count[4] = n + 1
    int nb;
    int sentinel;
};

// mask with the top nbits (clipped to 0..32) bits set
__device__ __forceinline__ uint32_t high_mask(int nbits) {
    if (nbits <= 0) return 0u;
    if (nbits >= 32) return FULL;
    return ~(FULL >> nbits);
}

// occ of the four bases in bwt[0:p), 0 <= p <= n + 1
__device__ __forceinline__ void occ4(const Fmi& f, int p, int o[4]) {
    int blk = p >> 6;
    if (blk > f.nb - 1) blk = f.nb - 1;
    const int off = p & 63;
    const int4 c = __ldg(f.cp_count + blk);
    const uint4 w01 = __ldg(f.cp_bits + 2 * blk);
    const uint4 w23 = __ldg(f.cp_bits + 2 * blk + 1);
    const uint32_t m0 = high_mask(off), m1 = high_mask(off - 32);
    o[0] = c.x + __popc(w01.x & m0) + __popc(w01.y & m1);
    o[1] = c.y + __popc(w01.z & m0) + __popc(w01.w & m1);
    o[2] = c.z + __popc(w23.x & m0) + __popc(w23.y & m1);
    o[3] = c.w + __popc(w23.z & m0) + __popc(w23.w & m1);
}

struct Intv {
    int k, l, s;
};

// backward extension of (k, l, s) by base a, with the sentinel rule for the
// complement side (reference: src/FMI_search.cpp:1039-1067); both blocks'
// loads are issued before either is used
__device__ __forceinline__ Intv backward_ext(const Fmi& f, int k, int l,
                                             int s, int a) {
    int ok[4], oks[4];
    occ4(f, k, ok);
    occ4(f, k + s, oks);
    const int sent = (k <= f.sentinel && k + s > f.sentinel) ? 1 : 0;
    const int l3 = l + sent;
    const int l2 = l3 + (oks[3] - ok[3]);
    const int l1 = l2 + (oks[2] - ok[2]);
    const int l0 = l1 + (oks[1] - ok[1]);
    Intv r;
    r.k = f.count[a] + ok[a];
    r.s = oks[a] - ok[a];
    r.l = a == 0 ? l0 : a == 1 ? l1 : a == 2 ? l2 : l3;
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

// the BWT base at rank p from the bitmaps, 4 at the sentinel
__device__ __forceinline__ int bwt_base(const Fmi& f, int p) {
    const int off = p & 63;
    const uint4 w01 = __ldg(f.cp_bits + 2 * (p >> 6));
    const uint4 w23 = __ldg(f.cp_bits + 2 * (p >> 6) + 1);
    const bool hi = off >= 32;
    const uint32_t bit = 1u << (31 - (off & 31));
    if ((hi ? w01.y : w01.x) & bit) return 0;
    if ((hi ? w01.w : w01.z) & bit) return 1;
    if ((hi ? w23.y : w23.x) & bit) return 2;
    if ((hi ? w23.w : w23.z) & bit) return 3;
    return 4;
}

// a thread a rank: LF-walk to a stored entry of the compressed suffix array
// or to the sentinel (reference: src/FMI_search.cpp:1117-1180)
__global__ void fmi_sa_lookup_kernel(Fmi f, const int32_t* rank, int n,
                                     int32_t* pos) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int sp = rank[i], offset = 0;
    while (sp & SA_COMPX_MASK) {
        const int b = bwt_base(f, sp);
        if (b == 4) {
            pos[i] = offset;
            return;
        }
        int o[4];
        occ4(f, sp, o);
        sp = f.count[b] + o[b];
        ++offset;
    }
    pos[i] = __ldg(f.sa_comp + (sp >> SA_COMPX)) + offset;
}

// ------------------------------------------------------------- launchers

static Fmi make_fmi(const void* count, const void* cp_count,
                    const void* cp_bits, const void* sa_comp, int nb,
                    int sentinel) {
    Fmi f;
    f.cp_count = (const int4*)cp_count;
    f.cp_bits = (const uint4*)cp_bits;
    f.sa_comp = (const int32_t*)sa_comp;
    for (int b = 0; b < 5; ++b) f.count[b] = ((const int32_t*)count)[b];
    f.nb = nb;
    f.sentinel = sentinel;
    return f;
}

static int blocks(int n) { return (n + THREADS - 1) / THREADS; }

// count: the five counts on the host (a kernel parameter)
#define FMI_PARAMS                                                          \
    const void *count, const void *cp_count, const void *cp_bits,          \
        const void *sa_comp, int nb, int sentinel
#define FMI_ARGS make_fmi(count, cp_count, cp_bits, sa_comp, nb, sentinel)

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
