// Banded affine-gap Smith-Waterman seed extension (bwa's ksw_extend2
// contract) for NVIDIA Hopper, sm_90a. One thread runs one extension job.
//
// Replaces the Pallas TPU kernel bwameme_tpu/ops/banded_sw_pallas.py:_kernel
// (launched by banded_sw_extend_batch_pallas). banded_sw_coord also folds in
// the XLA work that bwameme_tpu/ops/banded_sw.py:extend_side_round did around
// that kernel: decoding the 2-bit text window (_decode_text), slicing the
// query (_gather_query), gathering h0 per job and, on the left side, the
// score scatter (scatter_scores).
//
// What bounds it on this card: a job's DP is a serial chain. Row i needs row
// i-1, and inside a row each cell needs the previous cell's F and H. A job is
// about tlen x band cells of dependent integer max-plus work on 2 x (qlen+1)
// words of row state, so it is bound by latency per cell, by occupancy (a
// batch of ~10^4 jobs is ~300 warps over 132 SMs) and by divergence between
// the jobs of one warp. HBM bytes are not the limit, and wgmma/TMA do not
// apply: this is not a matrix product.
//
// What the design does about it: the row state lives in caller-allocated
// global scratch laid out [j][job], so at each step the 32 threads of a warp
// touch 32 neighbouring words, which coalesce and stay in L1/L2. The 5x5
// scoring matrix sits in shared memory. The caller sorts jobs by target
// length, so the jobs of one warp run for about as many rows. A warp per job
// with a shuffle max-scan for F is later work.
//
// Bit-exactness with the TPU kernel: the band clamp divides in f32 with
// round-to-nearest (build without --use_fast_math); row-max ties go to the
// largest j and gscore ties to the later row; the max update precedes the
// row-zero stop exactly as the Pallas kernel orders them (for h0 >= 0 this is
// the scalar order of align/sw_scalar.py, where a zero row cannot improve).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBadJob = -(1 << 30);  // every output of a job outside the contract

struct Gaps {
  int o_del, e_del, o_ins, e_ins, end_bonus, zdrop;
};

struct Result {
  int score, qle, tle, gtle, gscore, max_off;
};

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
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

// The DP of one job. eh_h/eh_e point at the job's column of the [j][job]
// scratch planes; stride is the number of jobs.
template <class QueryCodes, class TargetCodes>
__device__ Result extend_one(QueryCodes qcode, TargetCodes tcode, int qlen,
                             int tlen, int h0, int w, const int* smat,
                             int mx_sc, Gaps g, int* eh_h, int* eh_e,
                             size_t stride) {
  const int oe_del = g.o_del + g.e_del;
  const int oe_ins = g.o_ins + g.e_ins;
  const int max_ins = gap_cap(qlen, mx_sc, g.end_bonus, g.o_ins, g.e_ins);
  const int max_del = gap_cap(qlen, mx_sc, g.end_bonus, g.o_del, g.e_del);
  w = min(min(w, max_ins), max_del);

  // first row (banded_sw.py:114-118)
  eh_h[0] = h0;
  eh_e[0] = 0;
  for (int j = 1; j <= qlen; ++j) {
    int v = h0 - oe_ins - (j - 1) * g.e_ins;
    eh_h[j * stride] = v > 0 ? v : 0;
    eh_e[j * stride] = 0;
  }

  int mx = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;
  int beg = 0, end = qlen;
  for (int i = 0; i < tlen; ++i) {
    const int* srow = smat + 5 * clamp_int(tcode(i), 0, 4);
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    int h1 = 0;
    if (beg == 0) {
      h1 = h0 - (g.o_del + g.e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    }
    int f = 0, mrow = 0, mj = -1;
    for (int j = beg; j < end; ++j) {
      // eh_h[j] = H(i-1,j-1), eh_e[j] = E(i,j), f = F(i,j), h1 = H(i,j-1)
      int M = eh_h[j * stride];
      int e = eh_e[j * stride];
      eh_h[j * stride] = h1;
      M = M ? M + srow[clamp_int(qcode(j), 0, 4)] : 0;
      int h = M > e ? M : e;
      h = h > f ? h : f;
      h1 = h;
      if (mrow <= h) {  // ties: the largest j wins
        mrow = h;
        mj = j;
      }
      int t = M - oe_del;
      t = t > 0 ? t : 0;
      e -= g.e_del;
      e = e > t ? e : t;
      eh_e[j * stride] = e;
      t = M - oe_ins;
      t = t > 0 ? t : 0;
      f -= g.e_ins;
      f = f > t ? f : t;
    }
    if (end >= 0) {  // end < 0 only with w < 0: an empty row, which stops
      eh_h[end * stride] = h1;
      eh_e[end * stride] = 0;
    }
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
    // adaptive band pruning (sw_scalar.py:134-142)
    int j = beg;
    while (j < end && eh_h[j * stride] == 0 && eh_e[j * stride] == 0) ++j;
    beg = j;
    j = end;
    while (j >= beg && eh_h[j * stride] == 0 && eh_e[j * stride] == 0) --j;
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  return Result{mx, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off};
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
__global__ void __launch_bounds__(kThreads)
banded_sw_pairs(const int* __restrict__ q, const int* __restrict__ t, int B,
                int Q, int T, const int* __restrict__ qlen,
                const int* __restrict__ tlen, const int* __restrict__ h0,
                const int* __restrict__ ws, const int* __restrict__ mat,
                Gaps g, int* __restrict__ out, int* eh_h, int* eh_e) {
  __shared__ int smat[25];
  const int mx_sc = load_matrix(mat, smat);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int ql = qlen[b];
  Result r;
  if (ql < 0 || ql > Q) {
    r = Result{kBadJob, kBadJob, kBadJob, kBadJob, kBadJob, kBadJob};
  } else {
    const int tl = tlen[b] < T ? tlen[b] : T;  // the TPU kernel runs T rows
    r = extend_one(RowCodes{q + (size_t)b * Q}, RowCodes{t + (size_t)b * T},
                   ql, tl, h0[b], ws[b], smat, mx_sc, g, eh_h + b, eh_e + b,
                   (size_t)B);
  }
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
// reg in [0, Gp). Each alnreg has at most one job per side, so a thread reads
// and writes only its own entry; a lane whose reg lies outside [0, Gp) writes
// nothing. out (8,N): score, qle, tle, gtle, gscore, max_off, ws, h0.
__global__ void __launch_bounds__(kThreads)
banded_sw_coord(const uint32_t* __restrict__ text, long long n_words,
                const uint8_t* __restrict__ codes, int R, int L,
                const int* __restrict__ jobs, int N, int* score_reg, int Gp,
                int write_scores, int reverse, const int* __restrict__ mat,
                Gaps g, int* __restrict__ out, int* eh_h, int* eh_e) {
  __shared__ int smat[25];
  const int mx_sc = load_matrix(mat, smat);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int reg = jobs[n];
  const int row = clamp_int(jobs[N + n], 0, R - 1);
  const int qstart = jobs[2 * N + n];
  const int ql = jobs[3 * N + n];
  const int tstart = jobs[4 * N + n];
  const int tl = jobs[5 * N + n];
  const int w = jobs[6 * N + n];
  const int h0 = score_reg[clamp_int(reg, 0, Gp - 1)];
  Result r;
  if (ql < 0 || ql > L) {
    r = Result{kBadJob, kBadJob, kBadJob, kBadJob, kBadJob, kBadJob};
  } else {
    const bool rev = reverse != 0;
    r = extend_one(ReadSlice{codes + (size_t)row * L, qstart, ql, L, rev},
                   TextWindow{text, n_words, tstart > 0 ? tstart : 0, tl, rev},
                   ql, tl, h0, w, smat, mx_sc, g, eh_h + n, eh_e + n,
                   (size_t)N);
  }
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

}  // namespace

// Plain C entry points for ctypes. Each launches on the given stream and
// returns cudaGetLastError(): a refused launch never runs, and only this
// check reports it.
extern "C" int banded_sw_pairs_launch(
    const void* q, const void* t, int B, int Q, int T, const void* qlen,
    const void* tlen, const void* h0, const void* ws, const void* mat,
    int o_del, int e_del, int o_ins, int e_ins, int end_bonus, int zdrop,
    void* out, void* eh_h, void* eh_e, void* stream) {
  const Gaps g{o_del, e_del, o_ins, e_ins, end_bonus, zdrop};
  const int blocks = (B + kThreads - 1) / kThreads;
  banded_sw_pairs<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<const int*>(t), B, Q, T,
      static_cast<const int*>(qlen), static_cast<const int*>(tlen),
      static_cast<const int*>(h0), static_cast<const int*>(ws),
      static_cast<const int*>(mat), g, static_cast<int*>(out),
      static_cast<int*>(eh_h), static_cast<int*>(eh_e));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int banded_sw_coord_launch(
    const void* text, long long n_words, const void* codes, int R, int L,
    const void* jobs, int N, void* score_reg, int Gp, int write_scores,
    int reverse, const void* mat, int o_del, int e_del, int o_ins, int e_ins,
    int end_bonus, int zdrop, void* out, void* eh_h, void* eh_e,
    void* stream) {
  const Gaps g{o_del, e_del, o_ins, e_ins, end_bonus, zdrop};
  const int blocks = (N + kThreads - 1) / kThreads;
  banded_sw_coord<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(text), n_words,
      static_cast<const uint8_t*>(codes), R, L, static_cast<const int*>(jobs),
      N, static_cast<int*>(score_reg), Gp, write_scores, reverse,
      static_cast<const int*>(mat), g, static_cast<int*>(out),
      static_cast<int*>(eh_h), static_cast<int*>(eh_e));
  return static_cast<int>(cudaGetLastError());
}
