// FM-index seeding for Hopper (sm_90a): the bidirectional extension, the
// compressed suffix-array lookup and the SMEM search of a read, run to its
// end on the card.
//
// Replaces the XLA programs of bwameme_tpu/ops/fmi_search.py (occ :120,
// backward_ext_all :133, backward_ext :150, forward_ext :156, init_intv :160,
// sa_lookup :167) and the host-driven waves that bwameme_tpu/seeding/
// fmi_engine.py runs them in (FmiDeviceEngine._run_machines :265, the rounds
// :401-465). On the TPU a batch's SMEM state machines live on the host and
// every wave of extensions is one device call; here a thread runs one read's
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
// A read's intervals in flight (the prev list of _one_pos, at most one entry
// a base of the read) live in device memory that the wrapper sizes from the
// batch's longest read, (5, L + 1, R) words: entry p of read i at
// [p * R + i] of each plane, so that a warp's reads touch neighbouring words.
// The backward pass builds the next list in the same memory: entry c is
// written after entry p >= c was read. An emission past slot M is counted,
// not written: the wrapper reruns such a read with room for all of them.

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

// A read's view of the launch: its codes, its emission slots and its list
// of intervals in flight
struct Read {
    const uint8_t* codes;   // min(code, 4)
    int len;
    int* slots;             // start, end, k, s planes of (R, M)
    long long plane;        // R * M
    int M;
    int n;                  // emissions so far (past M counted, not kept)
    int* list;              // 5 planes (k, l, s, m, n) of (L + 1, R)
    long long lplane;       // (L + 1) * R
    int R;
    int steps;              // extensions run (the thread's dependent steps)
};

__device__ __forceinline__ void emit(Read& r, int start, int end, int k,
                                     int s) {
    if (r.n < r.M) {
        int* q = r.slots + r.n;
        q[0] = start;
        q[r.plane] = end;
        q[2 * r.plane] = k;
        q[3 * r.plane] = s;
    }
    ++r.n;
}

__device__ __forceinline__ void put(Read& r, int p, const Intv& x, int m,
                                    int n) {
    int* q = r.list + (long long)p * r.R;
    q[0] = x.k;
    q[r.lplane] = x.l;
    q[2 * r.lplane] = x.s;
    q[3 * r.lplane] = m;
    q[4 * r.lplane] = n;
}

__device__ __forceinline__ void get(const Read& r, int p, Intv& x, int& m,
                                    int& n) {
    const int* q = r.list + (long long)p * r.R;
    x.k = q[0];
    x.l = q[r.lplane];
    x.s = q[2 * r.lplane];
    m = q[3 * r.lplane];
    n = q[4 * r.lplane];
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
    const int m0 = x;
    int n0 = x, np = 0;
    for (int j = x + 1; j < r.len; ++j) {
        a = codes[j];
        next_x = j + 1;
        if (a >= 4) break;
        const Intv nx = forward_ext(f, cur, a);
        ++r.steps;
        if (nx.s != cur.s) put(r, np++, cur, m0, n0);
        if (nx.s < min_intv) {
            next_x = j;  // restart at the failing column
            break;
        }
        cur = nx;
        n0 = j;
    }
    if (cur.s >= min_intv) put(r, np++, cur, m0, n0);
    for (int i = 0, j = np - 1; i < j; ++i, --j) {  // longest first
        Intv xi, xj;
        int mi, ni, mj, nj;
        get(r, i, xi, mi, ni);
        get(r, j, xj, mj, nj);
        put(r, i, xj, mj, nj);
        put(r, j, xi, mi, ni);
    }
    for (int j = x - 1; j >= 0 && np > 0; --j) {
        a = codes[j];
        if (a >= 4) break;
        int nc = 0, curr_s = -1, p = 0;
        // until the first survivor or emission, then the survivors alone
        bool first = true;
        for (; p < np; ++p) {
            Intv px;
            int pm, pn;
            get(r, p, px, pm, pn);
            const Intv nx = backward_ext(f, px.k, px.l, px.s, a);
            ++r.steps;
            if (first && nx.s < min_intv && pn - pm + 1 >= min_seed) {
                emit(r, pm, pn + 1, px.k, px.s);
                first = false;
                continue;
            }
            if (nx.s >= min_intv && nx.s != curr_s) {
                curr_s = nx.s;
                put(r, nc++, nx, j, pn);  // nc <= p: entry p was read
                first = false;
            }
        }
        np = nc;
    }
    if (np > 0) {
        Intv px;
        int pm, pn;
        get(r, 0, px, pm, pn);
        if (pn - pm + 1 >= min_seed) emit(r, pm, pn + 1, px.k, px.s);
    }
    return next_x;
}

// round 3: forward-only sweeps (FmiHostEngine._bwt_seed_strategy,
// reference FMI_search.cpp:738-830)
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
                ++r.steps;
                if (cur.s < max_intv && j - x + 1 >= min_seed1) {
                    if (cur.s > 0) emit(r, x, j + 1, cur.k, cur.s);
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

__global__ void __launch_bounds__(THREADS)
fmi_smem_kernel(Fmi f, const uint8_t* codes, int L, const int32_t* lens,
                int R, SmemOpt o, int M, int32_t* slots, int32_t* nsm,
                int32_t* list, int32_t* steps) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R) return;
    Read r{codes + (long long)i * L, lens[i], slots + (long long)i * M,
           (long long)R * M, M, 0, list + i, (long long)(L + 1) * R, R, 0};
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
    nsm[i] = r.n;
    if (steps) steps[i] = r.steps;
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

int fmi_smem_launch(FMI_PARAMS, const void* codes, int L, const void* lens,
                    int R, int min_seed, int split_len, int split_width,
                    int max_mem_intv, int M, void* slots, void* nsm,
                    void* list, void* steps, void* stream) {
    if (R == 0) return 0;
    const SmemOpt o{min_seed, split_len, split_width, max_mem_intv};
    fmi_smem_kernel<<<blocks(R), THREADS, 0, (cudaStream_t)stream>>>(
        FMI_ARGS, (const uint8_t*)codes, L, (const int32_t*)lens, R, o, M,
        (int32_t*)slots, (int32_t*)nsm, (int32_t*)list, (int32_t*)steps);
    return (int)cudaGetLastError();
}

}  // extern "C"
