// Full (unbanded) local affine-gap Smith-Waterman for paired-end mate rescue
// (the kswv / ksw_align2 contract) for NVIDIA Hopper, sm_90a. One warp runs
// one job, its 32 lanes spread over the query's columns.
//
// Replaces the XLA program bwameme_tpu/ops/sw_full.py:full_sw_batch (:25)
// and the reverse pass of its host wrapper align_batch (:116-175). Per job:
// score (the best cell), te (the first row that strictly raised the best),
// qe (the smallest column attaining that row's maximum), score2/te2 (the
// best row maximum of at least min_sc outside te +/- ceil(score/max(mat)),
// the first such row on ties), and from a second launch over the reversed
// prefixes [0, qe] / [0, te] of the jobs with score > 0, tb = te - te_rev
// and qb = qe - qe_rev.
//
// What bounds it on this card: as in the banded kernel (banded_sw.cu), row i
// needs row i-1, so a job is a chain of tlen dependent rows, while the cells
// of a row are independent but for F, a max-plus prefix over the columns. A
// launch lasts about as long as its longest target's chain: rows x the
// latency of one row. The operations (about 12 int32 a cell) and the bytes
// (the codes in, seven words out) are far below that: a rescue batch of
// 1024 jobs of 151 x 530 cells is about 0.03 ms of int32 operations at the
// card's peak rate.
//
// What the design does:
// * A lane owns K = ceil(qlen / 32) consecutive columns of every row, the
//   same columns for the whole job (the matrix is not banded), and only it
//   reads and writes their state: H(i-1, j-1) (shifted, so that a column
//   reads its diagonal from its own slot), E(i, j) and the query's code, in
//   the warp's slice of shared memory, slot k*32 + lane for the lane's k-th
//   column (no bank conflicts whatever K). A row needs no barrier: the only
//   values that cross lanes are shuffled.
// * F: pass 1 takes the lane's maximum of u_j = max(hpre_j - oe_ins, 0) +
//   j*e_ins, an inclusive max scan by __shfl_up_sync across the lanes gives
//   F entering the lane's first column (F(i,j) = max(0, max_{k<j} u_k -
//   (j-1)*e_ins), exact in integers: the JAX program's cummax), pass 2 walks
//   the lane's columns with F carried in a register.
// * The row maximum with ties to the smallest column: each lane keeps its
//   first best (h, j) (strictly greater replaces), then two redux.sync give
//   the maximum and the smallest column among the lanes that hold it. te
//   moves only on a strictly larger row maximum.
// * score2 reads every row's maximum after the last row: lane (i mod 32)
//   writes row i's to device memory and reads it back, so no lane waits for
//   another; the first maximal row wins by a min over the lanes.
// * Queries of up to `cap` cells (the launch's, at most
//   sw_full_cuda.SHARED_CELLS) keep their state in shared memory; longer
//   ones in a slice of device memory that the wrapper allocates for the
//   launch. No query or target length is refused.
// * The target's codes are fetched 32 rows at a time, one row a lane, and a
//   row's code is shuffled out while the row before it runs. The coordinate
//   form reads them from the packed 2-bit text on the device by (tstart,
//   tlen), so only the mates' codes travel; its reverse pass reads the
//   forward pass's te/qe on the device, with no host round trip.
// * Warps take the jobs longest target first (the wrapper's order), 4 warps
//   a block.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

// The block's dynamic shared memory, a slice a warp: H and E of `cap` slots
// each, then `cap` query codes as bytes.
extern __shared__ int warp_state[];

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;  // jobs a block
constexpr int kThreads = kWarps * kLanes;
constexpr int kMinBlocks = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNegBig = -(1 << 28);  // "no column yet" in the F scan
constexpr int kNone = 0x7fffffff;    // "no column / row" in a min reduction

struct Gaps {
  int o_del, e_del, o_ins, e_ins;
};

struct Best {
  int score, te, qe;
};

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Query and target accessors: code of query column j / target row i.
struct IntRow {
  const int* row;
  __device__ int operator()(int k) const { return row[k]; }
};

struct ByteRow {
  const uint8_t* row;
  __device__ int operator()(int k) const { return row[k]; }
};

struct TextWindow {  // 16 bases a word, most significant first
  const uint32_t* text;
  long long n_words;
  long long start;
  __device__ int operator()(int i) const {
    long long p = start + i;
    long long w = p >> 4;
    if (w > n_words - 1) w = n_words - 1;
    return (int)((text[w] >> ((15 - (int)(p & 15)) * 2)) & 3u);
  }
};

template <class Codes>
struct Reversed {  // the first `len` codes, last first
  Codes codes;
  int len;
  __device__ int operator()(int k) const { return codes(len - 1 - k); }
};

// The words of a warp's state of `cap` slots (a multiple of 32)
__host__ __device__ inline int state_words(int cap) {
  return 2 * cap + cap / 4;
}

// The maximum of u over the lanes before this one (kNegBig for lane 0)
__device__ __forceinline__ int max_before(int u, int lane) {
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const int v = __shfl_up_sync(kFull, u, d);
    if (lane >= d) u = max(u, v);
  }
  u = __shfl_up_sync(kFull, u, 1);
  return lane ? u : kNegBig;
}

// One job's DP by the 32 lanes of a warp. The lane's k-th column j = j_lo + k
// keeps Hd (H(i-1, j-1)), Es (E(i, j)) and its query code in slot
// k*32 + lane. With rowmax, lane (i mod 32) stores row i's maximum there.
template <class QueryCodes, class TargetCodes>
__device__ __forceinline__ Best sw_warp(QueryCodes qcode, TargetCodes tcode,
                                        int qlen, int tlen, const int* smat,
                                        Gaps g, int* Hd, int* Es, uint8_t* qs,
                                        int* rowmax, int lane) {
  const int oe_del = g.o_del + g.e_del;
  const int oe_ins = g.o_ins + g.e_ins;
  const int K = (qlen + kLanes - 1) / kLanes;
  const int j_lo = min(lane * K, qlen);
  const int n = min(j_lo + K, qlen) - j_lo;  // the lane's columns
  for (int k = 0; k < n; ++k) {
    const int s = k * kLanes + lane;
    qs[s] = (uint8_t)clamp_int(qcode(j_lo + k), 0, 4);
    Hd[s] = 0;
    Es[s] = 0;
  }
  Best best{0, -1, -1};
  int tcodes = lane < tlen ? clamp_int(tcode(lane), 0, 4) : 0;
  int tc = __shfl_sync(kFull, tcodes, 0);
  for (int i = 0; i < tlen; ++i) {
    const int* srow = smat + 5 * tc;
    if (((i + 1) & (kLanes - 1)) == 0)
      tcodes = i + 1 + lane < tlen ? clamp_int(tcode(i + 1 + lane), 0, 4) : 0;
    tc = __shfl_sync(kFull, tcodes, (i + 1) & (kLanes - 1));

    int u = kNegBig;  // pass 1: the lane's maximum of u_j
    for (int k = 0; k < n; ++k) {
      const int s = k * kLanes + lane;
      const int hpre = max(max(Hd[s] + srow[qs[s]], Es[s]), 0);
      u = max(u, max(hpre - oe_ins, 0) + (j_lo + k) * g.e_ins);
    }
    const int cm = max_before(u, lane);
    int f = j_lo == 0 ? 0 : max(cm - (j_lo - 1) * g.e_ins, 0);

    int h = 0;  // pass 2: H(i, j-1), at the end the lane's last H
    int best_h = -1, best_j = kNone;
    for (int k = 0; k < n; ++k) {
      const int s = k * kLanes + lane;
      const int e = Es[s];
      const int hpre = max(max(Hd[s] + srow[qs[s]], e), 0);
      const int H = max(hpre, f);
      Es[s] = max(max(e - g.e_del, H - oe_del), 0);
      if (k > 0) Hd[s] = h;
      if (H > best_h) {  // ties: the smallest column wins
        best_h = H;
        best_j = j_lo + k;
      }
      f = max(f - g.e_ins, max(hpre - oe_ins, 0));
      h = H;
    }
    // the lane's first column takes H(i, j_lo - 1) from the lane before
    const int hp = __shfl_up_sync(kFull, h, 1);
    if (lane > 0 && n > 0) Hd[lane] = hp;

    const int rmax = max(__reduce_max_sync(kFull, best_h), 0);
    const int first =
        __reduce_min_sync(kFull, best_h == rmax ? best_j : kNone);
    if (rowmax != nullptr && lane == (i & (kLanes - 1))) rowmax[i] = rmax;
    if (rmax > best.score) {
      best.score = rmax;
      best.te = i;
      best.qe = first;
    }
  }
  return best;
}

// score2/te2 from the rows' maxima that sw_warp stored (lane i mod 32 reads
// row i, which it wrote itself)
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

__device__ __forceinline__ int load_matrix(const int* mat, int* smat) {
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  int mx = smat[0];
  for (int k = 1; k < 25; ++k) mx = smat[k] > mx ? smat[k] : mx;
  return mx;
}

// What both forms share: job b's state (shared memory while qlen <= cap,
// else its slice of `overflow`, Q cells), the forward pass with score2, or
// the reverse pass over the prefixes the forward pass left in `out` (7,B).
template <class QueryCodes, class TargetCodes, class RevQuery, class RevTarget>
__device__ __forceinline__ void run_job(QueryCodes qcode, TargetCodes tcode,
                                        RevQuery rq, RevTarget rt, int qlen,
                                        int tlen, int min_sc, int reverse,
                                        const int* smat, int mx, Gaps g,
                                        int cap, int* overflow, int Q,
                                        int* rowmax, int* out, int B, int b,
                                        int warp, int lane) {
  int* Hd;
  int slots;
  if (qlen <= cap) {
    Hd = warp_state + (size_t)warp * state_words(cap);
    slots = cap;
  } else {
    slots = (Q + kLanes - 1) / kLanes * kLanes;
    Hd = overflow + (size_t)b * state_words(slots);
  }
  int* Es = Hd + slots;
  uint8_t* qs = reinterpret_cast<uint8_t*>(Es + slots);
  if (!reverse) {
    const Best r = sw_warp(qcode, tcode, qlen, tlen, smat, g, Hd, Es, qs,
                           rowmax, lane);
    int score2, te2;
    second_best(rowmax, tlen, r, mx, min_sc, lane, &score2, &te2);
    if (lane != 0) return;
    out[b] = r.score;
    out[B + b] = r.te;
    out[2 * B + b] = r.qe;
    out[3 * B + b] = score2;
    out[4 * B + b] = te2;
    out[5 * B + b] = -1;
    out[6 * B + b] = -1;
    return;
  }
  if (out[b] <= 0) return;  // tb = qb = -1, as the forward pass left them
  const int te = out[B + b], qe = out[2 * B + b];
  rq.len = qe + 1;
  rt.len = te + 1;
  const Best r = sw_warp(rq, rt, qe + 1, te + 1, smat, g, Hd, Es, qs,
                         nullptr, lane);
  if (lane != 0) return;
  out[5 * B + b] = te - r.te;
  out[6 * B + b] = qe - r.qe;
}

// The pair form: q (B,Q), t (B,T) int32 codes; out (7,B) rows score, te, qe,
// score2, te2, tb, qb. rowmax (B,T) scratch.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sw_full_pairs(const int* __restrict__ q, const int* __restrict__ t, int B,
              int Q, int T, const int* __restrict__ qlen,
              const int* __restrict__ tlen, const int* __restrict__ min_sc,
              const int* __restrict__ mat, Gaps g, int reverse,
              const int* __restrict__ order, int cap, int* overflow,
              int* rowmax, int* out) {
  __shared__ int smat[25];
  const int mx = load_matrix(mat, smat);
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= B) return;
  const int b = order[n];
  const IntRow qr{q + (size_t)b * Q}, tr{t + (size_t)b * T};
  run_job(qr, tr, Reversed<IntRow>{qr, 0}, Reversed<IntRow>{tr, 0},
          clamp_int(qlen[b], 0, Q), clamp_int(tlen[b], 0, T), min_sc[b],
          reverse, smat, mx, g, cap, overflow, Q, rowmax + (size_t)b * T, out,
          B, b, warp, lane);
}

// The coordinate form: q (N,Q) uint8 codes; jobs (3,N) rows qlen, tstart,
// tlen: the target is text[tstart : tstart + tlen] of the packed text (both
// strands). rowmax (N,T) scratch; out as above.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sw_full_coord(const uint32_t* __restrict__ text, long long n_words,
              const uint8_t* __restrict__ q, int N, int Q, int T,
              const int* __restrict__ jobs, const int* __restrict__ min_sc,
              const int* __restrict__ mat, Gaps g, int reverse,
              const int* __restrict__ order, int cap, int* overflow,
              int* rowmax, int* out) {
  __shared__ int smat[25];
  const int mx = load_matrix(mat, smat);
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  const int b = order[n];
  const int tstart = jobs[N + b];
  const ByteRow qr{q + (size_t)b * Q};
  const TextWindow tw{text, n_words, tstart > 0 ? tstart : 0};
  run_job(qr, tw, Reversed<ByteRow>{qr, 0}, Reversed<TextWindow>{tw, 0},
          clamp_int(jobs[b], 0, Q), clamp_int(jobs[2 * N + b], 0, T),
          min_sc[b], reverse, smat, mx, g, cap, overflow, Q,
          rowmax + (size_t)b * T, out, N, b, warp, lane);
}

size_t shared_bytes(int cap) {
  return sizeof(int) * (size_t)kWarps * state_words(cap);
}

}  // namespace

// Plain C entry points for ctypes. Each launches on the given stream and
// returns cudaGetLastError(): a refused launch never runs, and only this
// check reports it.
extern "C" int sw_full_pairs_launch(
    const void* q, const void* t, int B, int Q, int T, const void* qlen,
    const void* tlen, const void* min_sc, const void* mat, int o_del,
    int e_del, int o_ins, int e_ins, int reverse, const void* order, int cap,
    void* overflow, void* rowmax, void* out, void* stream) {
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
      reverse, static_cast<const int*>(order), cap,
      static_cast<int*>(overflow), static_cast<int*>(rowmax),
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

extern "C" int sw_full_coord_launch(
    const void* text, long long n_words, const void* q, int N, int Q, int T,
    const void* jobs, const void* min_sc, const void* mat, int o_del,
    int e_del, int o_ins, int e_ins, int reverse, const void* order, int cap,
    void* overflow, void* rowmax, void* out, void* stream) {
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
      reverse, static_cast<const int*>(order), cap,
      static_cast<int*>(overflow), static_cast<int*>(rowmax),
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}
