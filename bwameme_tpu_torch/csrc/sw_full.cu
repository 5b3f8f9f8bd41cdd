// Full (unbanded) local affine-gap Smith-Waterman for paired-end mate rescue
// (the kswv / ksw_align2 contract) for NVIDIA Hopper, sm_90a. One warp runs
// one job, both passes, as an anti-diagonal wavefront over its lanes.
//
// Replaces the XLA program bwameme_tpu/ops/sw_full.py:full_sw_batch (:25)
// and the reverse pass of its host wrapper align_batch (:116-175). Per job:
// score (the best cell), te (the first row that strictly raised the best),
// qe (the smallest column attaining that row's maximum), score2/te2 (the
// best row maximum of at least min_sc outside te +/- ceil(score/max(mat)),
// the first such row on ties), and, with_start, from the reverse pass over
// the reversed prefixes [0, qe] / [0, te] of a job with score > 0,
// tb = te - te_rev and qb = qe - qe_rev.
//
// What bounds it on this card: cell (i, j) needs (i-1, j-1), (i-1, j) and
// (i, j-1), so a job is a chain of dependent steps however its cells are
// spread, and a batch lasts about as long as its longest job's chain: steps
// x the latency of one step. The operations (about 12 int32 a cell) and the
// bytes (the codes in, seven words out) are far below that: a rescue batch
// of 1024 jobs of 151 x 529 cells is about 0.03 ms of int32 operations at
// the card's peak rate.
//
// What the design does about it: it makes a step as short as a step can be.
// * A wavefront across the lanes. Lane l owns K = ceil(qlen / 32)
//   consecutive columns [j_lo, j_lo + K) for the whole job; at step s it
//   computes row i = s - l over them. What crosses a lane boundary comes
//   from lane l-1's previous step in one round of independent
//   __shfl_up_sync: H(i, j_lo - 1), F entering j_lo, row i's running
//   maximum and row i's target code. The diagonal H(i-1, j_lo - 1) is what
//   the lane received one step earlier. F runs as the plain recurrence
//   f = max(f - e_ins, hpre - o_ins - e_ins, 0) over the lane's columns,
//   exactly the JAX program's cummax closed form. A job takes tlen + (lanes
//   holding columns) - 1 steps.
// * No reduction a row: the row's maximum and its first column travel along
//   the wavefront as one key, H * 256 + (255 - j) (64 bits past 256
//   columns), taken by max, so a strictly greater H or, on a tie, the
//   smaller column wins. The last lane holding columns finishes row i and
//   moves (score, te, qe) only on a strictly larger row maximum; it stores
//   the row's maximum for score2, which the lanes read after the pass (lane
//   i mod 32 reads row i; the first maximal row wins by a min).
// * A step has no branch. A lane before its first row computes a row of
//   the code kNoRow, whose scores are 0, on its zero state, which leaves the
//   state zero; past the last row it computes rows nobody reads. Only the
//   last lane's bookkeeping is predicated.
// * Row state in registers: for queries of up to 256 bases (K <= 8, a
//   template parameter) H, E and each column's scores against the five
//   target codes (6 bits each, packed in a word) live in registers, and
//   nothing on a step's chain reads memory. Longer queries, and matrices
//   whose scores need more than 6 bits, run the same wavefront with the
//   lane's columns in the warp's slice of shared memory (queries of up to
//   `cap` cells, sw_full_cuda.SHARED_CELLS) or of a device-memory slice that
//   the wrapper allocates. No query or target length is refused.
// * The reverse pass stops at the forward score. Nothing in the reversed
//   prefix scores more than the forward best, and te_rev/qe_rev move only on
//   a strictly larger maximum, so once the reverse best equals the forward
//   score they are final: the warp ends the pass at that step.
// * One launch for both passes: the warp that ran a job's forward pass runs
//   its reverse pass right after, from te/qe in its registers.
// * The target's codes are loaded 32 rows at a time, one row a lane, a batch
//   ahead of their decoding; lane 0 shuffles out the code of its row, and
//   the code travels along the wavefront with its row. The coordinate form
//   reads them from the packed 2-bit text on the device by (tstart, tlen).
// * Warps take the jobs longest target first (the wrapper's order), 4 warps
//   a block.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

// The block's dynamic shared memory, a slice a warp for the jobs whose
// columns are not in registers: H and E of `cap` slots each, then `cap`
// query codes as bytes.
extern __shared__ int warp_state[];

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;  // jobs a block
constexpr int kThreads = kWarps * kLanes;
constexpr int kMinBlocks = 4;     // <= 128 registers: K = 8 without spills
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;  // "no column / row / goal"
constexpr int kNoRow = 5;          // the code of a row outside the target

struct Gaps {
  int o_del, e_del, o_ins, e_ins;
};

// a pass's best cell, and the steps the warp ran for it
struct Best {
  int score, te, qe, steps;
};

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// max(a + b, c, 0): one DPX instruction
__device__ __forceinline__ int addmax_relu(int a, int b, int c) {
  return __viaddmax_s32_relu(a, b, c);
}

__device__ __forceinline__ int shfl_up1(int v) {
  return __shfl_up_sync(kFull, v, 1);
}
__device__ __forceinline__ long long shfl_up1(long long v) {
  const int lo = __shfl_up_sync(kFull, (int)v, 1);
  const int hi = __shfl_up_sync(kFull, (int)(v >> 32), 1);
  return (long long)hi << 32 | (unsigned)lo;
}

// Code accessors: a query's column j by operator(); a target's row i in two
// halves, load (the word that holds it, fetched a batch of rows ahead) and
// decode (the code, clamped to 0-4).
struct IntRow {
  const int* row;
  __device__ int operator()(int k) const { return row[k]; }
  __device__ int load(int k) const { return row[k]; }
  __device__ int decode(int raw, int) const { return clamp_int(raw, 0, 4); }
};

struct ByteRow {
  const uint8_t* row;
  __device__ int operator()(int k) const { return row[k]; }
};

struct TextWindow {  // 16 bases a word, most significant first
  const uint32_t* text;
  long long n_words;
  long long start;
  __device__ int load(int i) const {
    const long long w = (start + i) >> 4;
    return (int)text[w < n_words - 1 ? w : n_words - 1];
  }
  __device__ int decode(int raw, int i) const {
    return (int)(((unsigned)raw >> ((15 - (int)((start + i) & 15)) * 2)) & 3u);
  }
};

template <class Codes>
struct Reversed {  // the first `len` codes, last first
  Codes codes;
  int len;
  __device__ int operator()(int k) const { return codes(len - 1 - k); }
  __device__ int load(int k) const { return codes.load(len - 1 - k); }
  __device__ int decode(int raw, int k) const {
    return codes.decode(raw, len - 1 - k);
  }
};

// The lane's K columns in registers: H(i-1, j) (after a row, H(i, j)),
// E(i, j), the column's scores mat[c][q_j] for the target codes c = 0-4,
// 6 bits each at bits 26 - 6c (bits 0-1 stay 0: the score of kNoRow), and
// the column's part of a row-maximum key, H * 256 + (255 - j): a larger key
// is a larger H or, on a tie, a smaller column. Columns past the query
// (the last lane's, and every column of the lanes after it) key far below
// any cell.
template <int K>
struct RegCols {
  using Key = int;
  static constexpr Key kNoKey = -1;
  int hp[K], e[K], prof[K], rc[K];
  template <class QueryCodes>
  __device__ __forceinline__ void init(QueryCodes qcode, int j_lo, int n,
                                       const int* smat) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      hp[k] = e[k] = prof[k] = 0;
      rc[k] = -(1 << 30);
      if (k < n) {
        const int qc = clamp_int(qcode(j_lo + k), 0, 4);
#pragma unroll
        for (int c = 0; c < 5; ++c)
          prof[k] |= (smat[5 * c + qc] & 63) << (26 - 6 * c);
        rc[k] = 255 - (j_lo + k);
      }
    }
  }
  __device__ __forceinline__ int row_sel(int tc) const { return 6 * tc; }
  __device__ __forceinline__ int score(int k, int sel) const {
    return (int)((unsigned)prof[k] << sel) >> 26;
  }
  __device__ __forceinline__ Key key(int H, int k) const {
    return H * 256 + rc[k];
  }
  static __device__ __forceinline__ int key_h(Key x) { return x >> 8; }
  static __device__ __forceinline__ int key_col(Key x) {
    return 255 - (x & 255);
  }
  __device__ __forceinline__ int& h(int k) { return hp[k]; }
  __device__ __forceinline__ int& ee(int k) { return e[k]; }
};

// The lane's columns in a slice of shared or device memory, the lane's k-th
// column in slot k*32 + lane (no bank conflicts whatever K); scores read
// from the matrix in shared memory (its row kNoRow all 0); 64-bit keys.
struct MemCols {
  using Key = long long;
  static constexpr Key kNoKey = -1;
  int* hp;
  int* e;
  uint8_t* qs;
  const int* smat;
  int lane, j_lo;
  template <class QueryCodes>
  __device__ __forceinline__ void init(QueryCodes qcode, int j_lo_, int n,
                                       const int*) {
    j_lo = j_lo_;
    for (int k = 0; k < n; ++k) {
      const int s = k * kLanes + lane;
      qs[s] = (uint8_t)clamp_int(qcode(j_lo + k), 0, 4);
      hp[s] = 0;
      e[s] = 0;
    }
  }
  __device__ __forceinline__ int row_sel(int tc) const { return 5 * tc; }
  __device__ __forceinline__ int score(int k, int sel) const {
    return smat[sel + qs[k * kLanes + lane]];
  }
  __device__ __forceinline__ Key key(int H, int k) const {
    return (long long)H << 32 | (unsigned)(kNone - (j_lo + k));
  }
  static __device__ __forceinline__ int key_h(Key x) { return (int)(x >> 32); }
  static __device__ __forceinline__ int key_col(Key x) {
    return kNone - (int)(unsigned)x;
  }
  __device__ __forceinline__ int& h(int k) { return hp[k * kLanes + lane]; }
  __device__ __forceinline__ int& ee(int k) { return e[k * kLanes + lane]; }
};

// Row i over the lane's columns j_lo + k (all K in registers, or n in
// memory when K is 0). diag enters as H(i-1, j_lo - 1), f as F(i, j_lo),
// mx as the key of row i's maximum left of j_lo; f and mx leave for the
// next lane. Returns H(i, j_lo + n - 1) (in registers, of the last column).
template <int K, class Cols>
__device__ __forceinline__ int row_cells(Cols& c, int n, int sel, int diag,
                                         int& f, typename Cols::Key& mx,
                                         Gaps g) {
  const int oe_del = g.o_del + g.e_del, oe_ins = g.o_ins + g.e_ins;
  int H = 0;
#pragma unroll
  for (int k = 0; k < (K ? K : n); ++k) {
    int& hk = c.h(k);
    int& ek = c.ee(k);
    const int up = hk;
    const int hpre = addmax_relu(diag, c.score(k, sel), ek);
    H = max(hpre, f);
    ek = addmax_relu(ek, -g.e_del, H - oe_del);
    f = addmax_relu(f, -g.e_ins, hpre - oe_ins);
    hk = H;
    mx = max(mx, c.key(H, k));
    diag = up;
  }
  return H;
}

// One pass of one job by the 32 lanes of a warp (qlen, tlen > 0). Lane l
// computes row s - l at step s; a lane before its first row computes the
// row kNoRow, whose scores are 0, and so leaves its zero state as it is;
// past the last row it computes rows nobody reads. goal: the score at which
// the pass may stop (kNone: run every row). With rowmax, the last lane
// stores each row's maximum there. Every lane returns the best.
template <int K, class Cols, class QueryCodes, class TargetCodes>
__device__ __forceinline__ Best wave(Cols& c, QueryCodes qcode,
                                     TargetCodes tcode, int qlen, int tlen,
                                     const int* smat, Gaps g, int goal,
                                     int* rowmax, int lane) {
  using Key = typename Cols::Key;
  const int kc = K ? K : (qlen + kLanes - 1) / kLanes;
  const int last = (qlen + kc - 1) / kc - 1;  // the last lane with columns
  const int j_lo = min(lane * kc, qlen);
  const int n = min(j_lo + kc, qlen) - j_lo;
  c.init(qcode, j_lo, n, smat);

  // the target's codes, a row a lane, fetched a batch of 32 rows ahead
  auto load = [&](int r) { return tcode.load(min(r, tlen - 1)); };
  auto decode = [&](int raw, int r) {
    return r < tlen ? tcode.decode(raw, r) : kNoRow;
  };
  int tnow = decode(load(lane), lane), traw = load(kLanes + lane);
  int best = 0, te = -1;
  Key best_key = Cols::kNoKey;
  int out_h = 0, out_f = 0, out_tc = kNoRow;
  Key out_mx = Cols::kNoKey;
  int diag = 0;  // H(i-1, j_lo - 1)
  const int steps = tlen + last;
  int s = 0;
  while (s < steps) {
    if (s > 0 && (s & (kLanes - 1)) == 0) {
      tnow = decode(traw, s + lane);
      traw = load(s + kLanes + lane);
    }
    const int tc0 = __shfl_sync(kFull, tnow, s & (kLanes - 1));
    int in_h = shfl_up1(out_h);
    int in_f = shfl_up1(out_f);
    Key in_mx = shfl_up1(out_mx);
    int in_tc = shfl_up1(out_tc);
    if (lane == 0) {
      in_h = in_f = 0;
      in_mx = Cols::kNoKey;
      in_tc = tc0;
    }
    out_f = in_f;
    out_mx = in_mx;
    out_tc = in_tc;
    out_h = row_cells<K>(c, n, c.row_sel(in_tc), diag, out_f, out_mx, g);
    diag = in_h;  // H(i, j_lo - 1): row i+1's diagonal
    const int i = s - lane;
    const bool row_done = lane == last && i >= 0 && i < tlen;
    const int rmax = Cols::key_h(out_mx);
    if (rowmax != nullptr && row_done) rowmax[i] = rmax;
    const bool up = row_done && rmax > best;
    best = up ? rmax : best;
    te = up ? i : te;
    best_key = up ? out_mx : best_key;
    ++s;
    if (goal != kNone && __ballot_sync(kFull, lane == last && best >= goal))
      break;
  }
  const int qe = te >= 0 ? Cols::key_col(best_key) : -1;
  return Best{__shfl_sync(kFull, best, last), __shfl_sync(kFull, te, last),
              __shfl_sync(kFull, qe, last), s};
}

// A pass with its columns in registers where the query and the matrix allow
// it, else in `mem`.
template <class QueryCodes, class TargetCodes>
__device__ __forceinline__ Best run_pass(QueryCodes qcode, TargetCodes tcode,
                                         int qlen, int tlen, const int* smat,
                                         bool packed, Gaps g, int goal,
                                         int* rowmax, MemCols mem, int lane) {
  if (qlen <= 0 || tlen <= 0) return Best{0, -1, -1, 0};
  if (packed) {
    switch ((qlen + kLanes - 1) / kLanes) {  // K: 1 to 8, qlen <= 256
#define SW_REG_CASE(KC)                                                   \
  case KC: {                                                              \
    RegCols<KC> c;                                                        \
    return wave<KC>(c, qcode, tcode, qlen, tlen, smat, g, goal, rowmax,   \
                    lane);                                                \
  }
      SW_REG_CASE(1)
      SW_REG_CASE(2)
      SW_REG_CASE(3)
      SW_REG_CASE(4)
      SW_REG_CASE(5)
      SW_REG_CASE(6)
      SW_REG_CASE(7)
      SW_REG_CASE(8)
#undef SW_REG_CASE
      default:
        break;
    }
  }
  return wave<0>(mem, qcode, tcode, qlen, tlen, smat, g, goal, rowmax, lane);
}

// score2/te2 from the rows' maxima that the forward pass stored, after a
// __syncwarp (lane i mod 32 reads row i)
__device__ __forceinline__ void second_best(const int* rowmax, int tlen,
                                            Best b, int mx, int min_sc,
                                            int lane, int* score2, int* te2) {
  const int rad = (b.score + mx - 1) / max(mx, 1);
  int best = 0, row = kNone;
  for (int i = lane; i < tlen; i += kLanes) {
    const int r = rowmax[i];
    const bool valid = (i < b.te - rad || i > b.te + rad) && r >= min_sc;
    if (valid && r > best) {  // ties: the first row wins
      best = r;
      row = i;
    }
  }
  *score2 = __reduce_max_sync(kFull, best);
  const int first = __reduce_min_sync(kFull, best == *score2 ? row : kNone);
  *te2 = *score2 > 0 ? first : -1;
}

// The matrix into shared memory, with a row of zeros for kNoRow; returns its
// maximum, and in *packed whether every score fits the registers' 6 bits
__device__ __forceinline__ int load_matrix(const int* mat, int* smat,
                                           bool* packed) {
  if (threadIdx.x < 30)
    smat[threadIdx.x] = threadIdx.x < 25 ? mat[threadIdx.x] : 0;
  __syncthreads();
  int mx = smat[0], mn = smat[0];
  for (int k = 1; k < 25; ++k) {
    mx = smat[k] > mx ? smat[k] : mx;
    mn = smat[k] < mn ? smat[k] : mn;
  }
  *packed = mn >= -32 && mx <= 31;
  return mx;
}

// Job b, both passes: the forward pass with score2, then with_start the
// reverse pass over the reversed prefixes. Its memory columns (for the
// passes that need them) are the warp's slice of shared memory while
// qlen <= cap, else job b's slice of `overflow` (Q cells). out (7,B) rows
// score, te, qe, score2, te2, tb, qb; steps (2,B), when given, the steps of
// each pass.
template <class QueryCodes, class TargetCodes>
__device__ __forceinline__ void run_job(QueryCodes qcode, TargetCodes tcode,
                                        int qlen, int tlen, int min_sc,
                                        int with_start, const int* smat,
                                        int mx, bool packed, Gaps g, int cap,
                                        int* overflow, int Q, int* rowmax,
                                        int* out, int* steps, int B, int b,
                                        int warp, int lane) {
  int* hp;
  int slots;
  if (qlen <= cap) {
    hp = warp_state + (size_t)warp * (2 * cap + cap / 4);
    slots = cap;
  } else {
    slots = (Q + kLanes - 1) / kLanes * kLanes;
    hp = overflow + (size_t)b * (2 * slots + slots / 4);
  }
  const MemCols mem{hp, hp + slots,
                    reinterpret_cast<uint8_t*>(hp + 2 * slots), smat, lane,
                    0};
  const Best f = run_pass(qcode, tcode, qlen, tlen, smat, packed, g, kNone,
                          rowmax, mem, lane);
  __syncwarp();
  int score2, te2;
  second_best(rowmax, qlen > 0 ? tlen : 0, f, mx, min_sc, lane, &score2,
              &te2);
  Best r{0, -1, -1, 0};
  const bool rev = with_start && f.score > 0;
  if (rev)
    r = run_pass(Reversed<QueryCodes>{qcode, f.qe + 1},
                 Reversed<TargetCodes>{tcode, f.te + 1}, f.qe + 1, f.te + 1,
                 smat, packed, g, f.score, nullptr, mem, lane);
  if (lane != 0) return;
  out[b] = f.score;
  out[B + b] = f.te;
  out[2 * B + b] = f.qe;
  out[3 * B + b] = score2;
  out[4 * B + b] = te2;
  out[5 * B + b] = rev ? f.te - r.te : -1;
  out[6 * B + b] = rev ? f.qe - r.qe : -1;
  if (steps != nullptr) {
    steps[b] = f.steps;
    steps[B + b] = r.steps;
  }
}

// The pair form: q (B,Q), t (B,T) int32 codes. rowmax (B,T) scratch.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sw_full_pairs(const int* __restrict__ q, const int* __restrict__ t, int B,
              int Q, int T, const int* __restrict__ qlen,
              const int* __restrict__ tlen, const int* __restrict__ min_sc,
              const int* __restrict__ mat, Gaps g, int with_start,
              const int* __restrict__ order, int cap, int* overflow,
              int* rowmax, int* out, int* steps) {
  __shared__ int smat[30];
  bool packed;
  const int mx = load_matrix(mat, smat, &packed);
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= B) return;
  const int b = order[n];
  run_job(IntRow{q + (size_t)b * Q}, IntRow{t + (size_t)b * T},
          clamp_int(qlen[b], 0, Q), clamp_int(tlen[b], 0, T), min_sc[b],
          with_start, smat, mx, packed, g, cap, overflow, Q,
          rowmax + (size_t)b * T, out, steps, B, b, warp, lane);
}

// The coordinate form: q (N,Q) uint8 codes; jobs (3,N) rows qlen, tstart,
// tlen: the target is text[tstart : tstart + tlen] of the packed text (both
// strands). rowmax (N,T) scratch.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sw_full_coord(const uint32_t* __restrict__ text, long long n_words,
              const uint8_t* __restrict__ q, int N, int Q, int T,
              const int* __restrict__ jobs, const int* __restrict__ min_sc,
              const int* __restrict__ mat, Gaps g, int with_start,
              const int* __restrict__ order, int cap, int* overflow,
              int* rowmax, int* out, int* steps) {
  __shared__ int smat[30];
  bool packed;
  const int mx = load_matrix(mat, smat, &packed);
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  const int b = order[n];
  const int tstart = jobs[N + b];
  run_job(ByteRow{q + (size_t)b * Q},
          TextWindow{text, n_words, tstart > 0 ? tstart : 0},
          clamp_int(jobs[b], 0, Q), clamp_int(jobs[2 * N + b], 0, T),
          min_sc[b], with_start, smat, mx, packed, g, cap, overflow, Q,
          rowmax + (size_t)b * T, out, steps, N, b, warp, lane);
}

size_t shared_bytes(int cap) {
  return sizeof(int) * (size_t)kWarps * (2 * cap + cap / 4);
}

}  // namespace

// Plain C entry points for ctypes. Each launches on the given stream and
// returns cudaGetLastError(): a refused launch never runs, and only this
// check reports it.
extern "C" int sw_full_pairs_launch(
    const void* q, const void* t, int B, int Q, int T, const void* qlen,
    const void* tlen, const void* min_sc, const void* mat, int o_del,
    int e_del, int o_ins, int e_ins, int with_start, const void* order,
    int cap, void* overflow, void* rowmax, void* out, void* steps,
    void* stream) {
  const Gaps g{o_del, e_del, o_ins, e_ins};
  const size_t bytes = shared_bytes(cap);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sw_full_pairs, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + kWarps - 1) / kWarps;
  sw_full_pairs<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      static_cast<const int*>(q), static_cast<const int*>(t), B, Q, T,
      static_cast<const int*>(qlen), static_cast<const int*>(tlen),
      static_cast<const int*>(min_sc), static_cast<const int*>(mat), g,
      with_start, static_cast<const int*>(order), cap,
      static_cast<int*>(overflow), static_cast<int*>(rowmax),
      static_cast<int*>(out), static_cast<int*>(steps));
  return (int)cudaGetLastError();
}

extern "C" int sw_full_coord_launch(
    const void* text, long long n_words, const void* q, int N, int Q, int T,
    const void* jobs, const void* min_sc, const void* mat, int o_del,
    int e_del, int o_ins, int e_ins, int with_start, const void* order,
    int cap, void* overflow, void* rowmax, void* out, void* steps,
    void* stream) {
  const Gaps g{o_del, e_del, o_ins, e_ins};
  const size_t bytes = shared_bytes(cap);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sw_full_coord, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  sw_full_coord<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(text), n_words,
      static_cast<const uint8_t*>(q), N, Q, T, static_cast<const int*>(jobs),
      static_cast<const int*>(min_sc), static_cast<const int*>(mat), g,
      with_start, static_cast<const int*>(order), cap,
      static_cast<int*>(overflow), static_cast<int*>(rowmax),
      static_cast<int*>(out), static_cast<int*>(steps));
  return (int)cudaGetLastError();
}
