// Banded affine-gap Smith-Waterman seed extension (bwa's ksw_extend2
// contract) for NVIDIA Hopper, sm_90a. One warp runs one extension job, its
// 32 lanes spread over the query positions of a row.
//
// Replaces the Pallas TPU kernel bwameme_tpu/ops/banded_sw_pallas.py:_kernel
// (launched by banded_sw_extend_batch_pallas). banded_sw_coord also folds in
// the XLA work that bwameme_tpu/ops/banded_sw.py:extend_side_round did around
// that kernel: decoding the 2-bit text window (_decode_text), slicing the
// query (_gather_query), gathering h0 per job and, on the left side, the
// score scatter (scatter_scores).
//
// What bounds it on this card: a job's rows are a serial chain (row i needs
// row i-1), but inside a row nothing is: E and F are fed by the diagonal
// term M, and M(i,j) needs only row i-1, so all cells of a row can be
// computed at once with F as a max-plus prefix scan over j (the property
// the Pallas kernel's _scan_max uses). A launch then lasts about as long as
// its longest job's chain: rows x the latency of one row, 0.7 to 0.9 us on
// an H100 however wide the row is (the scan's six dependent shuffles, the
// cells' shared-memory loads and arithmetic, four redux, and the scalar
// bookkeeping that every lane repeats: band, maxima, z-drop, pruning). Of
// the 4096 pair jobs that chip_smoke.py times (Q = 151, T <= 512), the one
// with the longest chain (300 rows) takes 0.24 ms alone and the batch 0.4 ms,
// 0.3 ms with its heavy jobs first: 25 to 40 times the int32 operation
// bound, held by instruction latency in one warp's chain, not by throughput
// or memory, which is why the callers sort their jobs. At most 64 registers
// a thread let 32 warps live on an SM, 4224 on the card, so the 4096 jobs of
// a batch are resident together. HBM bytes are not the limit (a job reads a
// few hundred bytes), and wgmma/TMA do not apply: this is no matrix product.
//
// What the design does:
// * Row state lives in the warp's slice of shared memory, in the scalar
//   code's own layout: Hs[j] = H(i-1,j-1) (shifted), Es[j] = E(i,j), beside
//   the query's codes as bytes. A job needs the cells of its live band only
//   (a row reads [beg, end) and stores [beg, end], and end - beg + 1 <=
//   min(qlen + 1, 2w + 2)). Queries of up to 4095 bases get a slot a cell.
//   Longer ones get a window of 4096 slots that slides along the query with
//   the band: when the band reaches the window's end, the live cells move
//   down to its start (once in 2048 rows or more) and the cells ahead are
//   filled in as row -1 left them, a closed formula. So shared memory
//   bounds the band, not the query. A job whose band has more than 2048
//   live cells on such a query (w > 1023) keeps its rows in a slice of
//   device memory that the launcher allocates for launches with such
//   queries, on the stream, and frees after them: same code, the other
//   address space. Neither Q nor T nor w has an upper limit.
// * A lane owns K = ceil(n / 32) consecutive cells of a row of n cells and
//   reads and writes only those, so a row needs no barrier inside (one
//   __syncwarp ends it) and one scan across the lanes whatever its width:
//   pass 1 takes the lane's maximum of u_j = max(M_j - oe_ins, 0) + j*e_ins,
//   an inclusive max scan by __shfl_up_sync turns it into F entering the
//   lane's first cell (F(i,j) = max(0, max_{beg<=k<j} u_k - (j-1)*e_ins),
//   exact in integers), pass 2 walks the lane's cells with F carried in a
//   register. Rows of up to 5 cells a lane, 160 cells (every row of a 151 bp
//   read), are unrolled: all loads first, M and E kept in registers between
//   the passes, selects instead of branches; wider rows (long reads) take a
//   looped form of the same two passes. Unrolling up to 8 cells a lane made
//   the 201-cell rows of 1 kbp reads 7% faster and the short reads' 10%
//   slower (registers spill), so it stops at 5.
// * The row maximum with ties to the largest j: each lane keeps its best
//   (h, j) (>= so the later j wins), then two redux.sync give the maximum
//   and the largest j among the lanes that hold it.
// * The adaptive band pruning never re-reads the state: "new Hs[j] and
//   Es[j] are zero" is known in registers when they are stored, so each lane
//   keeps its first and last non-zero cell and two redux.sync (min, max)
//   give the row's.
// * Every exit (z-drop, zero row, empty band) is uniform in the warp and
//   ends that warp only: jobs of different length no longer wait for each
//   other. Blocks are 4 warps, 8 blocks an SM, so a finished block frees
//   its slot early (1 to 16 warps a block measured within 15%).
// * The query's codes are staged with the state, clamped to 0..4; the
//   target's codes are decoded 32 rows at a time, one row a lane, and a
//   row's code is fetched by a shuffle while the row before it runs. The
//   5x5 matrix sits in shared memory.
// * Hopper's DPX instructions (__viaddmax_s32, __viaddmax_s32_relu,
//   __vimax3_s32) fuse the recurrence's add-max-clamp steps. Plain min/max
//   measured the same time: the compiler fuses them itself.
//
// Bit-exactness with the TPU kernel: the band clamp divides in f32 with
// round-to-nearest (build without --use_fast_math); row-max ties go to the
// largest j and gscore ties to the later row; the max update precedes the
// row-zero stop exactly as the Pallas kernel orders them (for h0 >= 0 this is
// the scalar order of align/sw_scalar.py, where a zero row cannot improve).
// Cells outside a row's band keep what an earlier row left there, as in the
// scalar code: the pruning can grow `end` by one and read such a cell.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

// The block's dynamic shared memory, a slice a warp: Hs and Es of `cap`
// words each, then `cap` query codes as bytes.
extern __shared__ int warp_state[];

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;  // jobs a block
constexpr int kThreads = kWarps * kLanes;
constexpr int kMinBlocks = 1024 / kThreads;  // 32 warps an SM: <= 64 registers
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBadJob = -(1 << 30);  // every output of a job outside the contract
constexpr int kNegBig = -(1 << 28);  // "no cell yet" in the F scan
constexpr int kNoCell = 0x7fffffff;  // "no non-zero cell" in the pruning
constexpr int kWindow = 4096;  // slots of a warp's state past 4095 bases

struct Gaps {
  int o_del, e_del, o_ins, e_ins, end_bonus, zdrop;
};

struct Result {
  int score, qle, tle, gtle, gscore, max_off;
};

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// max(a + b, c), max(a + b, c, 0) and max(a, b, c): one DPX instruction each
__device__ __forceinline__ int addmax(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);
}
__device__ __forceinline__ int addmax_relu(int a, int b, int c) {
  return __viaddmax_s32_relu(a, b, c);
}
__device__ __forceinline__ int max3(int a, int b, int c) {
  return __vimax3_s32(a, b, c);
}

// max(int((qlen*mx + end_bonus - o) / e + 1.0), 1) in f32, as
// banded_sw_pallas.py:214-221 computes it
__device__ __forceinline__ int gap_cap(int qlen, int mx, int end_bonus, int o,
                                       int e) {
  float v = __fadd_rn(__fdiv_rn(__int2float_rn(qlen * mx + end_bonus - o),
                                __int2float_rn(e)),
                      1.0f);
  int c = __float2int_rz(v);
  return c > 1 ? c : 1;
}

// Query and target accessors: code of query position j / target row i.
struct RowCodes {
  const int* row;
  __device__ int operator()(int k) const { return row[k]; }
};

struct ReadSlice {  // banded_sw.py:_gather_query
  const uint8_t* row;
  int start, len, L;
  bool reverse;
  __device__ int operator()(int j) const {
    int k = start + (reverse ? len - 1 - j : j);
    return row[clamp_int(k, 0, L - 1)];
  }
};

struct TextWindow {  // banded_sw.py:_decode_text, 16 bases per word, MSB first
  const uint32_t* text;
  long long n_words;
  long long start;
  int len;
  bool reverse;
  __device__ int operator()(int i) const {
    long long p = start + (reverse ? len - 1 - i : i);
    long long w = p >> 4;
    if (w > n_words - 1) w = n_words - 1;
    return (int)((text[w] >> ((15 - (int)(p & 15)) * 2)) & 3u);
  }
};

// The words of a job's state of `cap` cells: Hs, Es, and the query's codes
__host__ __device__ inline int state_words(int cap) {
  return 2 * cap + (cap + 3) / 4;
}

// The most cells of a job's state that are alive at once: a row reads
// [beg, end) and stores [beg, end], beg >= i - w, end <= min(i + w + 1, qlen)
__device__ __forceinline__ int live_cells(int qlen, int w) {
  return w >= qlen ? qlen + 1 : min(qlen + 1, 2 * w + 2);
}

// What a lane brings out of a row: its maximum (h, the largest j that holds
// it), the first and the last non-zero cell of the state it stored, and
// H(i, end-1).
struct RowPart {
  int best_h, best_j, first_nz, last_nz, h1;
};

// F(i, j_lo) of a lane whose cells start at j_lo, from every lane's maximum
// u of u_j = max(M_j - oe_ins, 0) + j*e_ins over its own cells: an inclusive
// max scan across the lanes, shifted by one lane. F(i,j) = max(0, max_{k<j}
// u_k - (j-1)*e_ins), and F(i, beg) = 0.
__device__ __forceinline__ int f_entering(int u, int j_lo, int e_ins,
                                          int lane) {
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const int v = __shfl_up_sync(kFull, u, d);
    if (lane >= d) u = max(u, v);
  }
  u = __shfl_up_sync(kFull, u, 1);
  return lane ? addmax(u, -(j_lo - 1) * e_ins, 0) : 0;
}

// What is left of a row after the lanes' own cells: h is a lane's last
// H(i,j), en_lo its E(i+1, j_lo). Hs[j_lo] takes H(i, j_lo-1) from the lane
// before (a lane with cells follows only full lanes; lane 0 takes h1, which
// enters as H(i, beg-1)), and cell end takes (H(i, end-1), 0) from the lane
// `owner` that holds the row's last cell.
__device__ __forceinline__ void close_row(RowPart& out, int* Hs, int* Es,
                                          int h, int en_lo, int j_lo,
                                          int j_hi, int end, int owner,
                                          int h1, int lane) {
  int hp = __shfl_up_sync(kFull, h, 1);
  if (lane == 0) hp = h1;
  out.h1 = __shfl_sync(kFull, h, owner);
  if (j_lo < j_hi) {
    Hs[j_lo] = hp;
    if ((hp | en_lo) != 0) {
      out.first_nz = j_lo;
      out.last_nz = max(out.last_nz, j_lo);
    }
  }
  if (lane == 0) {
    Hs[end] = out.h1;
    Es[end] = 0;
  }
}

// The cells [beg, end) of one row, n > 0 of them: a lane owns K =
// ceil(n / 32) consecutive cells, so the row costs one scan across the lanes
// whatever its width. Pass 1 finds the lane's maximum of u_j; the scan
// (f_entering) turns it into F entering the lane's first cell; pass 2 walks
// the cells in order with F carried in the lane; close_row joins the lanes.
// Hs[j] = H(i-1,j-1), Es[j] = E(i,j), qs[j] the query's code; h1 enters as
// H(i, beg-1).
//
// row_cells<KU>, KU == K > 0: both passes unrolled, every load started before
// the first use (a lone warp hides no latency: cell after cell, each with its
// three dependent shared-memory loads, cost 180 cycles a cell), M and E kept
// in registers between the passes, selects instead of branches.
template <int KU>
__device__ __forceinline__ RowPart row_cells(int* Hs, int* Es,
                                             const uint8_t* qs,
                                             const int* srow, int beg,
                                             int end, int h1, int lane,
                                             int oe_ins, int oe_del,
                                             int e_ins, int e_del) {
  const int j_lo = min(beg + lane * KU, end);
  const int j_hi = min(j_lo + KU, end);
  int M[KU], e[KU], t[KU];
#pragma unroll
  for (int k = 0; k < KU; ++k) {  // cells past j_hi read a cell of the row
    const int jc = min(j_lo + k, end - 1);
    M[k] = Hs[jc];
    e[k] = Es[jc];
    t[k] = qs[jc];
  }
#pragma unroll
  for (int k = 0; k < KU; ++k) t[k] = srow[t[k]];
  int u = kNegBig;
#pragma unroll
  for (int k = 0; k < KU; ++k) {
    const int j = j_lo + k;
    M[k] = M[k] ? M[k] + t[k] : 0;
    t[k] = addmax(M[k], -oe_ins, 0);
    u = j < j_hi ? max(u, t[k] + j * e_ins) : u;
  }
  int f = f_entering(u, j_lo, e_ins, lane);

  RowPart out{-1, -1, kNoCell, -1, 0};
  int h = 0;  // H(i, j-1), at the end the lane's last H
#pragma unroll
  for (int k = 0; k < KU; ++k) {
    const int j = j_lo + k;
    const bool valid = j < j_hi;
    const int en = addmax_relu(e[k], -e_del, M[k] - oe_del);  // E(i+1, j)
    const int hk = max3(M[k], e[k], f);                       // H(i, j)
    const bool nz = valid && k > 0 && (h | en) != 0;  // of (Hs[j], Es[j])
    out.first_nz = nz ? min(out.first_nz, j) : out.first_nz;
    out.last_nz = nz ? j : out.last_nz;
    const bool best = valid && hk >= out.best_h;  // ties: the largest j wins
    out.best_h = best ? hk : out.best_h;
    out.best_j = best ? j : out.best_j;
    e[k] = h;   // what Hs[j] takes
    M[k] = en;  // what Es[j] takes
    h = valid ? hk : h;
    f = addmax(f, -e_ins, t[k]);
  }
#pragma unroll
  for (int k = 0; k < KU; ++k) {
    const int j = j_lo + k;
    if (j < j_hi) {
      Es[j] = M[k];
      if (k > 0) Hs[j] = e[k];
    }
  }
  close_row(out, Hs, Es, h, M[0], j_lo, j_hi, end, (end - beg - 1) / KU, h1,
            lane);
  return out;
}

// The same row for any K, looped, M computed in both passes: rows wider than
// 160 cells.
__device__ __forceinline__ RowPart row_cells_looped(
    int* Hs, int* Es, const uint8_t* qs, const int* srow, int beg, int end,
    int K, int h1, int lane, int oe_ins, int oe_del, int e_ins, int e_del) {
  const int j_lo = min(beg + lane * K, end);
  const int j_hi = min(j_lo + K, end);
  int u = kNegBig;
  for (int j = j_lo; j < j_hi; ++j) {
    const int hs = Hs[j];
    const int M = hs ? hs + srow[qs[j]] : 0;
    u = max(u, addmax(M, -oe_ins, 0) + j * e_ins);
  }
  int f = f_entering(u, j_lo, e_ins, lane);

  RowPart out{-1, -1, kNoCell, -1, 0};
  int h = 0, en_lo = 0;  // H(i, j-1); E(i+1, j_lo)
  for (int j = j_lo; j < j_hi; ++j) {
    const int hs = Hs[j];
    const int e = Es[j];
    const int M = hs ? hs + srow[qs[j]] : 0;
    const int en = addmax_relu(e, -e_del, M - oe_del);
    Es[j] = en;
    if (j > j_lo) {
      Hs[j] = h;
      if ((h | en) != 0) {
        out.first_nz = min(out.first_nz, j);
        out.last_nz = j;
      }
    } else {
      en_lo = en;
    }
    h = max3(M, e, f);
    if (h >= out.best_h) {
      out.best_h = h;
      out.best_j = j;
    }
    f = addmax(f, -e_ins, addmax(M, -oe_ins, 0));
  }
  close_row(out, Hs, Es, h, en_lo, j_lo, j_hi, end, (end - beg - 1) / K, h1,
            lane);
  return out;
}

// Move the n cells from slot `shift` on down to slot 0, 32 at a time: every
// lane reads its cell before any writes, and a chunk's reads lie past all
// that earlier chunks wrote.
__device__ __forceinline__ void move_down(int* Hs, int* Es, uint8_t* qs,
                                          int shift, int n, int lane) {
  for (int k = lane; k - lane < n; k += kLanes) {
    const int src = min(k, n - 1) + shift;
    const int h = Hs[src], e = Es[src], c = qs[src];
    __syncwarp();
    if (k < n) {
      Hs[k] = h;
      Es[k] = e;
      qs[k] = (uint8_t)c;
    }
    __syncwarp();
  }
}

// The DP of one job, run by the 32 lanes of a warp together; w is the band
// after its clamp (clamped_band). Every scalar of the scalar code (beg, end,
// the maxima) is held by all lanes alike, so all branches on them are
// uniform. The state (Hs, Es, qs) has `cap` slots, at least
// live_cells(qlen, w), and holds the cells [base, base + cap): a slot a cell
// from cell 0 on while qlen + 1 <= cap, else a window that slides along the
// query with the band. Inlined into each caller, so that the loads and
// stores of the state are those of its address space.
template <class QueryCodes, class TargetCodes>
__device__ __forceinline__ Result extend_warp(
    QueryCodes qcode, TargetCodes tcode, int qlen, int tlen, int h0, int w,
    const int* smat, Gaps g, int* Hs, int* Es, uint8_t* qs, int cap,
    int lane) {
  const int oe_del = g.o_del + g.e_del;
  const int oe_ins = g.o_ins + g.e_ins;
  int mx = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;
  int beg = 0, end = qlen;
  int base = 0;    // slot 0 holds cell `base`; Hs, Es, qs are indexed by cell
  int filled = 0;  // cells [base, filled) are in the state
  // the target's codes, 32 rows at a time, one row a lane; a row's code is
  // fetched from its lane while the row before it runs
  int tcodes = lane < tlen ? clamp_int(tcode(lane), 0, 4) : 0;
  int tc = __shfl_sync(kFull, tcodes, 0);
  for (int i = 0; i < tlen; ++i) {
    const int* srow = smat + 5 * tc;
    if (((i + 1) & (kLanes - 1)) == 0)
      tcodes = i + 1 + lane < tlen ? clamp_int(tcode(i + 1 + lane), 0, 4) : 0;
    tc = __shfl_sync(kFull, tcodes, (i + 1) & (kLanes - 1));
    beg = max(beg, i - w);
    end = min(min(end, i + w + 1), qlen);
    if (end >= filled) {
      // The row stores cell `end`, which is not in the state yet. Before row
      // 0 the state is empty; later the window is full (filled == base +
      // cap): slide it to the band's first cell, beg, below which no row
      // reads again. Then bring in the cells up to the window's end as row
      // -1 left them (banded_sw.py:114-118), each with its query code. With
      // a slot a cell this runs once, before row 0.
      if (filled > 0) {
        move_down(Hs + base, Es + base, qs + base, beg - base, filled - beg,
                  lane);
        Hs -= beg - base;
        Es -= beg - base;
        qs -= beg - base;
        base = beg;
      }
      const int upto = min(qlen + 1, base + cap);
      for (int j = filled + lane; j < upto; j += kLanes) {
        if (j < qlen) qs[j] = (uint8_t)clamp_int(qcode(j), 0, 4);
        Hs[j] = j == 0 ? h0 : max(h0 - oe_ins - (j - 1) * g.e_ins, 0);
        Es[j] = 0;
      }
      filled = upto;
      __syncwarp();
    }
    int h1 = 0;  // H(i, beg-1), then H(i, end-1)
    if (beg == 0) h1 = max(h0 - (g.o_del + g.e_del * (i + 1)), 0);

    const int n = end - beg;
    RowPart part{-1, -1, kNoCell, -1, h1};
    if (n > 0) {  // an empty row stops below: its state is never read
      const int K = (n + kLanes - 1) / kLanes;
#define BSW_ROW(KU)                                                  \
  part = row_cells<KU>(Hs, Es, qs, srow, beg, end, h1, lane, oe_ins, \
                       oe_del, g.e_ins, g.e_del)
      switch (K) {
        case 1: BSW_ROW(1); break;
        case 2: BSW_ROW(2); break;
        case 3: BSW_ROW(3); break;
        case 4: BSW_ROW(4); break;
        case 5: BSW_ROW(5); break;
        default:
          part = row_cells_looped(Hs, Es, qs, srow, beg, end, K, h1, lane,
                                  oe_ins, oe_del, g.e_ins, g.e_del);
      }
#undef BSW_ROW
      h1 = part.h1;
    }
    const int first_nz = __reduce_min_sync(kFull, part.first_nz);
    const int last_nz = __reduce_max_sync(kFull, part.last_nz);
    const int mrow = max(__reduce_max_sync(kFull, part.best_h), 0);
    const int mj =
        __reduce_max_sync(kFull, part.best_h == mrow ? part.best_j : -1);

    if (end == qlen && gscore <= h1) {  // ties: the later row wins
      max_ie = i;
      gscore = h1;
    }
    const bool improved = mrow > mx;
    if (improved) {
      mx = mrow;
      max_i = i;
      max_j = mj;
      int off = mj > i ? mj - i : i - mj;
      if (off > max_off) max_off = off;
    }
    if (mrow == 0) break;
    if (!improved && g.zdrop > 0) {
      int di = (i - max_i) - (mj - max_j);
      int z = di > 0 ? mx - mrow - di * g.e_del : mx - mrow + di * g.e_ins;
      if (z > g.zdrop) break;
    }
    // adaptive band pruning (sw_scalar.py:134-142) on the state just
    // stored: cells beg..end-1 from the lanes, cell end holds (h1, 0)
    beg = first_nz != kNoCell ? first_nz : end;
    const int last = h1 != 0 ? end : (last_nz >= 0 ? last_nz : beg - 1);
    end = min(last + 2, qlen);
    __syncwarp();  // the next row reads what other lanes stored
  }
  return Result{mx, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off};
}

// A job's band: w, at most the longest gap its query's score could pay for
__device__ __forceinline__ int clamped_band(int qlen, int w, int mx_sc,
                                            Gaps g) {
  return min(min(w, gap_cap(qlen, mx_sc, g.end_bonus, g.o_ins, g.e_ins)),
             gap_cap(qlen, mx_sc, g.end_bonus, g.o_del, g.e_del));
}

// One job on the warp's slice of shared memory (cap slots) or, when its
// query has more cells than that and its band more live cells than `room`,
// on its own slice of `overflow` (a slot a cell of queries up to Q there).
template <class QueryCodes, class TargetCodes>
__device__ __forceinline__ Result extend_job(
    QueryCodes qcode, TargetCodes tcode, int qlen, int tlen, int h0, int w,
    const int* smat, int mx_sc, Gaps g, int cap, int room, int* overflow,
    size_t job, int Q, int warp, int lane) {
  w = clamped_band(qlen, w, mx_sc, g);
  if (qlen + 1 <= cap || live_cells(qlen, w) <= room) {
    int* Hs = warp_state + (size_t)warp * state_words(cap);
    int* Es = Hs + cap;
    return extend_warp(qcode, tcode, qlen, tlen, h0, w, smat, g, Hs, Es,
                       reinterpret_cast<uint8_t*>(Es + cap), cap, lane);
  }
  int* Hs = overflow + job * state_words(Q + 1);
  int* Es = Hs + Q + 1;
  return extend_warp(qcode, tcode, qlen, tlen, h0, w, smat, g, Hs, Es,
                     reinterpret_cast<uint8_t*>(Es + Q + 1), Q + 1, lane);
}

__device__ __forceinline__ int load_matrix(const int* mat, int* smat) {
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  int mx = smat[0];
  for (int k = 1; k < 25; ++k) mx = smat[k] > mx ? smat[k] : mx;
  return mx;
}

// K1's exact contract on code matrices: q (B,Q), t (B,T) int32 codes 0-4;
// out (6,B) rows score, qle, tle, gtle, gscore, max_off.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
banded_sw_pairs(const int* __restrict__ q, const int* __restrict__ t, int B,
                int Q, int T, const int* __restrict__ qlen,
                const int* __restrict__ tlen, const int* __restrict__ h0,
                const int* __restrict__ ws, const int* __restrict__ mat,
                Gaps g, int cap, int room, int* overflow,
                int* __restrict__ out) {
  __shared__ int smat[25];
  const int mx_sc = load_matrix(mat, smat);
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  const int ql = qlen[b];
  Result r;
  if (ql < 0 || ql > Q) {
    r = Result{kBadJob, kBadJob, kBadJob, kBadJob, kBadJob, kBadJob};
  } else {
    const int tl = tlen[b] < T ? tlen[b] : T;  // the TPU kernel runs T rows
    r = extend_job(RowCodes{q + (size_t)b * Q}, RowCodes{t + (size_t)b * T},
                   ql, tl, h0[b], ws[b], smat, mx_sc, g, cap, room, overflow,
                   b, Q, warp, lane);
  }
  if (lane != 0) return;
  out[b] = r.score;
  out[B + b] = r.qle;
  out[2 * B + b] = r.tle;
  out[3 * B + b] = r.gtle;
  out[4 * B + b] = r.gscore;
  out[5 * B + b] = r.max_off;
}

// One side of an extension round in coordinates (banded_sw.py:
// extend_side_round). jobs (7,N): reg, row, qstart, qlen, tstart, tlen, ws.
// h0 = score_reg[clamp(reg)]; with write_scores, score_reg[reg] = score for
// reg in [0, Gp). Each alnreg has at most one job per side, so a warp reads
// and writes only its own entry, through lane 0 alone; a job whose reg lies
// outside [0, Gp) writes nothing. out (8,N): score, qle, tle, gtle, gscore,
// max_off, ws, h0.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
banded_sw_coord(const uint32_t* __restrict__ text, long long n_words,
                const uint8_t* __restrict__ codes, int R, int L,
                const int* __restrict__ jobs, int N, int* score_reg, int Gp,
                int write_scores, int reverse, const int* __restrict__ mat,
                Gaps g, int cap, int room, int* overflow,
                int* __restrict__ out) {
  __shared__ int smat[25];
  const int mx_sc = load_matrix(mat, smat);
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  const int reg = jobs[n];
  const int row = clamp_int(jobs[N + n], 0, R - 1);
  const int qstart = jobs[2 * N + n];
  const int ql = jobs[3 * N + n];
  const int tstart = jobs[4 * N + n];
  const int tl = jobs[5 * N + n];
  const int w = jobs[6 * N + n];
  int h0 = 0;
  if (lane == 0) h0 = score_reg[clamp_int(reg, 0, Gp - 1)];
  h0 = __shfl_sync(kFull, h0, 0);
  Result r;
  if (ql < 0 || ql > L) {
    r = Result{kBadJob, kBadJob, kBadJob, kBadJob, kBadJob, kBadJob};
  } else {
    const bool rev = reverse != 0;
    r = extend_job(ReadSlice{codes + (size_t)row * L, qstart, ql, L, rev},
                   TextWindow{text, n_words, tstart > 0 ? tstart : 0, tl, rev},
                   ql, tl, h0, w, smat, mx_sc, g, cap, room, overflow, n, L,
                   warp, lane);
  }
  if (lane != 0) return;
  if (write_scores && reg >= 0 && reg < Gp) score_reg[reg] = r.score;
  out[n] = r.score;
  out[N + n] = r.qle;
  out[2 * N + n] = r.tle;
  out[3 * N + n] = r.gtle;
  out[4 * N + n] = r.gscore;
  out[5 * N + n] = r.max_off;
  out[6 * N + n] = w;
  out[7 * N + n] = h0;
}

// Where a launch of `jobs` jobs with queries up to Q keeps its row state: a
// slot a cell in shared memory while that fits; else a sliding window there
// for the jobs whose live band fills at most half of it (`room`, so that the
// window slides at most once in cap / 2 rows) and, for the others, a slice
// each of device memory allocated on the stream (null when none is needed).
struct StatePlan {
  int cap, room;
  size_t shared_bytes;
  int* overflow;
};

cudaError_t plan_state(int Q, int jobs, cudaStream_t stream, StatePlan* p) {
  const bool slides = Q + 1 > kWindow;
  p->cap = slides ? kWindow : Q + 1;
  p->room = slides ? kWindow / 2 : Q + 1;
  p->shared_bytes = sizeof(int) * (size_t)kWarps * state_words(p->cap);
  p->overflow = nullptr;
  if (!slides) return cudaSuccess;
  return cudaMallocAsync(reinterpret_cast<void**>(&p->overflow),
                         sizeof(int) * (size_t)jobs * state_words(Q + 1),
                         stream);
}

// After the launch: its error, or that of freeing the overflow slices (the
// free is ordered on the stream behind the kernel)
cudaError_t finish_launch(const StatePlan& p, cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (p.overflow == nullptr) return err;
  const cudaError_t freed = cudaFreeAsync(p.overflow, stream);
  return err != cudaSuccess ? err : freed;
}

}  // namespace

// Plain C entry points for ctypes. Each launches on the given stream and
// returns cudaGetLastError(): a refused launch never runs, and only this
// check reports it.
extern "C" int banded_sw_pairs_launch(
    const void* q, const void* t, int B, int Q, int T, const void* qlen,
    const void* tlen, const void* h0, const void* ws, const void* mat,
    int o_del, int e_del, int o_ins, int e_ins, int end_bonus, int zdrop,
    void* out, void* stream) {
  const Gaps g{o_del, e_del, o_ins, e_ins, end_bonus, zdrop};
  StatePlan p;
  cudaError_t err = plan_state(Q, B, (cudaStream_t)stream, &p);
  if (err == cudaSuccess && p.shared_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(banded_sw_pairs,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.shared_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kWarps - 1) / kWarps;
  const size_t bytes = p.shared_bytes;
  banded_sw_pairs<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      static_cast<const int*>(q), static_cast<const int*>(t), B, Q, T,
      static_cast<const int*>(qlen), static_cast<const int*>(tlen),
      static_cast<const int*>(h0), static_cast<const int*>(ws),
      static_cast<const int*>(mat), g, p.cap, p.room, p.overflow,
      static_cast<int*>(out));
  return (int)finish_launch(p, (cudaStream_t)stream);
}

extern "C" int banded_sw_coord_launch(
    const void* text, long long n_words, const void* codes, int R, int L,
    const void* jobs, int N, void* score_reg, int Gp, int write_scores,
    int reverse, const void* mat, int o_del, int e_del, int o_ins, int e_ins,
    int end_bonus, int zdrop, void* out, void* stream) {
  const Gaps g{o_del, e_del, o_ins, e_ins, end_bonus, zdrop};
  StatePlan p;
  cudaError_t err = plan_state(L, N, (cudaStream_t)stream, &p);
  if (err == cudaSuccess && p.shared_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(banded_sw_coord,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.shared_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kWarps - 1) / kWarps;
  const size_t bytes = p.shared_bytes;
  banded_sw_coord<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(text), n_words,
      static_cast<const uint8_t*>(codes), R, L, static_cast<const int*>(jobs),
      N, static_cast<int*>(score_reg), Gp, write_scores, reverse,
      static_cast<const int*>(mat), g, p.cap, p.room, p.overflow,
      static_cast<int*>(out));
  return (int)finish_launch(p, (cudaStream_t)stream);
}
