// Banded global alignment with traceback (bwa's ksw_global2, exactly as
// native/hostkernels.cpp sw_global_c computes it for bwa_gen_cigar2) for
// NVIDIA Hopper, sm_90a: the score and CIGAR of every region a single-end
// batch writes to SAM, one launch a batch, one warp a job.
//
// Replaces the host's sw_global_c inside the single-end finalize (the C++
// plan lists the regions that reg2aln will align, this kernel aligns them,
// the C++ emit writes the SAM). It has no TPU counterpart: the JAX package
// runs this DP on the host too.
//
// What bounds it on this card: as in banded_sw.cu, a job's rows are a
// serial chain and a row is not: M(i,j) needs only row i-1, E and F are fed
// by M (ksw_global2 opens both gaps from M, not from H), so a row's cells
// are computed at once with F as a max-plus prefix scan over j. A launch
// lasts about as long as one job's chain of rows plus its traceback; a
// 4096-read batch's ~4300 jobs fill the card about once (7 blocks of 4
// warps an SM by shared memory). HBM bytes are a few hundred a job.
//
// What the design does:
// * One warp a job. The row state Hs[j] = H(i-1,j-1) (shifted), Es[j] =
//   E(i,j) and the query's codes live in the warp's slice of shared memory,
//   in the scalar code's own layout, indexed by query position; lanes take
//   32 consecutive cells of a row at a time (one pass for bands up to 15,
//   two up to 31), the F scan carried from pass to pass.
// * The traceback needs every cell's direction: 2 bits for H's source (M,
//   E, F), 1 for "E extends", 1 for "F extends", a nibble a cell, eight
//   cells a word, packed by three shuffles. A row has ceil(n_col / 8) words,
//   n_col = min(qlen, 2w+1) as in the scalar code, so a 151 bp read with a
//   band of 11 keeps 453 words; nothing of the DP goes to device memory.
// * A job whose state passes the warp's slice (`budget_words`: long reads,
//   wide bands) is not run: its result is flagged, and the host recomputes
//   it. That depends on the job's shape only.
// * The traceback is lane 0's, over the nibbles, with the current run in
//   registers; the runs go to a scratch in shared memory and leave in
//   SAM order as packed len<<4|op words. A CIGAR of more runs than the
//   job's output slot, or a step off the band (the scalar code would read a
//   neighbouring row's cell there), is flagged too.
// * gen_cigar's no-DP branch (qlen == rlen and band 0) is a warp sum.
//
// Bit-exactness with sw_global_c: the recurrence, NEG_INF and the tie rules
// (m >= e, h < f, e > t, f > t) are the scalar code's; F(i,j) = max(
// NEG_INF - (j-beg)e, max_{beg<=k<j} (M_k - oe_ins) - (j-1-k)e) is the scan
// over u_k = M_k - oe_ins + k*e_ins, exact in integers; cells of a row past
// its band read as 0, as the scalar code's zeroed buffer does. The band
// clamp divides in double, as gen_cigar does.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

// The block's dynamic shared memory: `budget_words` words a warp
extern __shared__ int warp_state[];

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;  // jobs a block
constexpr int kThreads = kWarps * kLanes;
constexpr int kMinBlocks = 8;  // <= 64 registers a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNegInf = -0x40000000;  // sw_global_c's NEG_INF
constexpr int kNoCell = -(3 << 29);   // below every u of the F scan
// what a job's count of runs holds instead when the host must recompute it
constexpr int kOverBudget = -1;  // its state passes the warp's slice
constexpr int kOverSlots = -2;   // its CIGAR has more runs than its slot
constexpr int kOffBand = -3;     // its traceback left the band

struct Gaps {
  int o_del, e_del, o_ins, e_ins;
};

// gen_cigar's band: (max_gap + |rlen - qlen| + 1) / 2, at most w, at least
// |rlen - qlen| + 3, max_gap from the longest gap half the query could pay
// for, in double as the host computes it
__device__ __forceinline__ int band_width(int qlen, int rlen, int w, int a,
                                          Gaps g) {
  const int half = ((qlen + 1) >> 1) * a;
  const int max_ins = (int)((double)(half - g.o_ins) / (double)g.e_ins + 1.0);
  const int max_del = (int)((double)(half - g.o_del) / (double)g.e_del + 1.0);
  int max_gap = max_ins > max_del ? max_ins : max_del;
  if (max_gap < 1) max_gap = 1;
  const int diff = rlen > qlen ? rlen - qlen : qlen - rlen;
  int ww = (max_gap + diff + 1) >> 1;
  if (ww > w) ww = w;
  if (ww < diff + 3) ww = diff + 3;
  return ww;
}

// The words of a job's state in its warp's slice: Hs and Es, the query's
// codes as bytes, the direction nibbles of every row, the runs' scratch
__host__ __device__ inline long long state_words(int qlen, int tlen, int ww,
                                                 int slots) {
  const int n_col = qlen < 2 * ww + 1 ? qlen : 2 * ww + 1;
  return 2LL * (qlen + 1) + (qlen + 3) / 4 +
         (long long)((n_col + 7) >> 3) * tlen + slots;
}

struct Target {  // text[rb : rb + len], reversed on the reverse strand
  const uint32_t* text;
  long long n_words, rb;
  int len;
  bool rev;
  __device__ int operator()(int i) const {
    const long long p = rb + (rev ? len - 1 - i : i);
    long long w = p >> 4;
    if (w > n_words - 1) w = n_words - 1;
    if (w < 0) w = 0;
    return (int)((text[w] >> ((15 - (int)(p & 15)) * 2)) & 3u);
  }
};

// The DP of one job with w = ww, qlen, tlen > 0, in the warp's slice; then
// lane 0's traceback into o: o[0] the score, o[1] the count of runs (or a
// flag), o[2..] the runs.
__device__ __forceinline__ void align_job(const uint8_t* query, bool rev,
                                          Target tcode, int qlen, int tlen,
                                          int ww, const int* smat, Gaps g,
                                          int slots, int* slice, int* o,
                                          int lane) {
  const int oe_del = g.o_del + g.e_del, oe_ins = g.o_ins + g.e_ins;
  const int n_col = qlen < 2 * ww + 1 ? qlen : 2 * ww + 1;
  const int RW = (n_col + 7) >> 3;
  int* Hs = slice;
  int* Es = Hs + qlen + 1;
  uint8_t* qs = reinterpret_cast<uint8_t*>(Es + qlen + 1);
  uint32_t* Z = reinterpret_cast<uint32_t*>(Es + qlen + 1) + (qlen + 3) / 4;
  int* runs = reinterpret_cast<int*>(Z + (size_t)RW * tlen);

  // row -1 as the scalar code leaves it: H(-1, j-1) = -(o_ins + e_ins*j)
  // for j <= w, E = NEG_INF; the query clamped to 0..4; no direction yet
  for (int j = lane; j <= qlen; j += kLanes) {
    Hs[j] = j == 0 ? 0 : (j <= ww ? -(g.o_ins + g.e_ins * j) : kNegInf);
    Es[j] = kNegInf;
  }
  for (int j = lane; j < qlen; j += kLanes) {
    const int c = query[rev ? qlen - 1 - j : j];
    qs[j] = (uint8_t)(c > 4 ? 4 : c);
  }
  for (int k = lane; k < RW * tlen; k += kLanes) Z[k] = 0;
  __syncwarp();

  // the target's codes, 32 rows at a time, one row a lane
  int tcodes = lane < tlen ? tcode(lane) : 0;
  int tc = __shfl_sync(kFull, tcodes, 0);
  for (int i = 0; i < tlen; ++i) {
    const int* srow = smat + 5 * tc;
    if (((i + 1) & (kLanes - 1)) == 0)
      tcodes = i + 1 + lane < tlen ? tcode(i + 1 + lane) : 0;
    tc = __shfl_sync(kFull, tcodes, (i + 1) & (kLanes - 1));
    const int beg = i > ww ? i - ww : 0;
    const int end = i + ww + 1 < qlen ? i + ww + 1 : qlen;
    // H(i, beg-1) and the scan's value before the row's first cell
    int carry_h = beg == 0 ? -(g.o_del + g.e_del * (i + 1)) : kNegInf;
    int carry_u = kNegInf + (beg - 1) * g.e_ins;
    uint32_t* zrow = Z + (size_t)i * RW;
    for (int c0 = beg; c0 < end; c0 += kLanes) {
      const int j = c0 + lane;
      const bool valid = j < end;
      const int jc = valid ? j : end - 1;
      const int m = Hs[jc] + srow[qs[jc]];
      const int e = Es[jc];
      int d = m >= e ? 0 : 1;
      int h = m >= e ? m : e;
      const int tdel = m - oe_del;
      const bool ext_e = e - g.e_del > tdel;
      const int en = ext_e ? e - g.e_del : tdel;  // E(i+1, j)
      const int tins = m - oe_ins;
      // inclusive max scan of u_j = tins + j*e_ins, then F entering j
      int v = valid ? tins + j * g.e_ins : kNoCell;
#pragma unroll
      for (int s = 1; s < kLanes; s <<= 1) {
        const int x = __shfl_up_sync(kFull, v, s);
        if (lane >= s) v = max(v, x);
      }
      int before = __shfl_up_sync(kFull, v, 1);
      if (lane == 0) before = kNoCell;
      const int f = max(carry_u, before) - (j - 1) * g.e_ins;
      if (h < f) {
        d = 2;
        h = f;
      }
      d |= (ext_e ? 4 : 0) | (f - g.e_ins > tins ? 8 : 0);
      int hp = __shfl_up_sync(kFull, h, 1);  // H(i, j-1)
      if (lane == 0) hp = carry_h;
      if (valid) {
        Hs[j] = hp;
        Es[j] = en;
      }
      // eight nibbles a word; a row's words past its band stay 0
      int word = valid ? d << ((lane & 7) * 4) : 0;
      word |= __shfl_sync(kFull, word, lane ^ 1);
      word |= __shfl_sync(kFull, word, lane ^ 2);
      word |= __shfl_sync(kFull, word, lane ^ 4);
      const int widx = ((c0 - beg) >> 3) + (lane >> 3);
      if ((lane & 7) == 0 && widx < RW) zrow[widx] = (uint32_t)word;
      const int last = end - c0 < kLanes ? end - c0 - 1 : kLanes - 1;
      carry_h = __shfl_sync(kFull, h, last);
      carry_u = max(carry_u, __shfl_sync(kFull, v, kLanes - 1));
    }
    if (lane == 0) {
      Hs[end] = carry_h;
      Es[end] = kNegInf;
    }
    __syncwarp();
  }

  int n = 0;
  if (lane == 0) {
    const int score = Hs[qlen];
    int flag = 0, which = 0, op = -1, len = 0;
    int i = tlen - 1;
    int k = (i + ww + 1 < qlen ? i + ww + 1 : qlen) - 1;
    // a finished run goes to the scratch, last run first
    auto push = [&](int o2, int l2) -> bool {
      if (o2 == op) {
        len += l2;
        return true;
      }
      if (op >= 0) {
        if (n >= slots) return false;
        runs[n++] = len << 4 | op;
      }
      op = o2;
      len = l2;
      return true;
    };
    while (i >= 0 && k >= 0) {
      const int c = k - (i > ww ? i - ww : 0);
      if (c < 0 || c >= n_col) {
        flag = kOffBand;
        break;
      }
      const int nib = (int)(Z[(size_t)i * RW + (c >> 3)] >> ((c & 7) * 4));
      which = which == 0 ? nib & 3
                         : (which == 1 ? (nib >> 2) & 1 : ((nib >> 3) & 1) * 2);
      bool ok;
      if (which == 0) {
        ok = push(0, 1);
        --i;
        --k;
      } else if (which == 1) {
        ok = push(2, 1);
        --i;
      } else {
        ok = push(1, 1);
        --k;
      }
      if (!ok) {
        flag = kOverSlots;
        break;
      }
    }
    if (!flag && i >= 0 && !push(2, i + 1)) flag = kOverSlots;
    if (!flag && k >= 0 && !push(1, k + 1)) flag = kOverSlots;
    if (!flag && op >= 0) {
      if (n >= slots)
        flag = kOverSlots;
      else
        runs[n++] = len << 4 | op;
    }
    o[0] = score;
    o[1] = flag ? flag : n;
    if (flag) n = 0;
  }
  n = __shfl_sync(kFull, n, 0);
  __syncwarp();
  for (int t = lane; t < n; t += kLanes) o[2 + t] = runs[n - 1 - t];
}

// One job a warp. jobs (5, N) int64: rb, the query's first code in `codes`,
// qlen, rlen (the target is text[rb : rb + rlen], both reversed when rb >=
// l_pac) and the band w. out (N, 2 + slots) int32: the score, the count of
// runs (or kOverBudget, kOverSlots, kOffBand) and the runs, len<<4|op (0 M,
// 1 I, 2 D), in SAM order, 0 past them.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sw_global_coord(const uint32_t* __restrict__ text, long long n_words,
                const uint8_t* __restrict__ codes,
                const long long* __restrict__ jobs, int N, long long l_pac,
                const int* __restrict__ mat, Gaps g, int slots,
                int budget_words, int* __restrict__ out) {
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;
  const long long rb = jobs[n];
  const uint8_t* query = codes + jobs[(size_t)N + n];
  const int qlen = (int)jobs[2 * (size_t)N + n];
  const int tlen = (int)jobs[3 * (size_t)N + n];
  const int w = (int)jobs[4 * (size_t)N + n];
  int* o = out + (size_t)n * (2 + slots);
  for (int t = lane; t < slots; t += kLanes) o[2 + t] = 0;  // unused runs
  __syncwarp();
  const bool rev = rb >= l_pac;
  const Target tcode{text, n_words, rb, tlen, rev};
  if (qlen <= 0 || tlen <= 0) {  // outside the contract: the host's
    if (lane == 0) {
      o[0] = 0;
      o[1] = kOverBudget;
    }
    return;
  }
  if (qlen == tlen && w == 0) {  // gen_cigar's no-DP branch
    int sc = 0;
    for (int j = lane; j < qlen; j += kLanes) {
      const int q = query[rev ? qlen - 1 - j : j];
      sc += smat[5 * tcode(j) + (q > 4 ? 4 : q)];
    }
    sc = __reduce_add_sync(kFull, sc);
    if (lane == 0) {
      o[0] = sc;
      o[1] = slots > 0 ? 1 : kOverSlots;
      if (slots > 0) o[2] = qlen << 4;
    }
    return;
  }
  const int ww = band_width(qlen, tlen, w, smat[0], g);
  if (state_words(qlen, tlen, ww, slots) > budget_words) {
    if (lane == 0) {
      o[0] = 0;
      o[1] = kOverBudget;
    }
    return;
  }
  align_job(query, rev, tcode, qlen, tlen, ww, smat, g, slots,
            warp_state + (size_t)warp * budget_words, o, lane);
}

}  // namespace

// Plain C entry point for ctypes: launches on the given stream and returns
// cudaGetLastError(), so a refused launch is reported.
extern "C" int sw_global_coord_launch(
    const void* text, long long n_words, const void* codes, const void* jobs,
    int N, long long l_pac, const void* mat, int o_del, int e_del, int o_ins,
    int e_ins, int slots, int budget_words, void* out, void* stream) {
  const Gaps g{o_del, e_del, o_ins, e_ins};
  const size_t bytes = sizeof(int) * (size_t)kWarps * budget_words;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sw_global_coord, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  sw_global_coord<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(text), n_words,
      static_cast<const uint8_t*>(codes), static_cast<const long long*>(jobs),
      N, l_pac, static_cast<const int*>(mat), g, slots, budget_words,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}
