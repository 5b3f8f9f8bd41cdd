// The port's host library: native/hostkernels.cpp (shared with bwameme_tpu,
// which builds it on its own), included whole and left as it is, and the
// single-end finalize (its finalize_se_c) in two halves around the card's
// banded global alignment (csrc/sw_global.cu):
//
//   plan   per read: sort_dedup_patch, the ALT flag, mark_primary,
//          reorder_primary5 (finalize_se_c's own steps), then every region
//          that reg2aln will align, in gen_alt's and reg2sam_se's order, as a
//          job with reg2aln's first band (fin_se_plan_c, fin_se_jobs_c);
//   card   one sw_global_coord launch over the jobs (ops/sw_global.py);
//   host   gen_cigar for the jobs the kernel flagged and for those whose
//          score starts reg2aln's band ladder, which goes on here from the
//          kernel's first band to where the host's own ladder would end
//          (fin_se_cigar_host_c);
//   emit   per read: reg2aln on the jobs' scores and CIGARs (NM, MD,
//          clipping, position), gen_alt's XA strings and aln2sam_se: the
//          text finalize_se_c writes, byte for byte (fin_se_emit_c).
//
// The split reuses the fin:: machinery of hostkernels.cpp (built with
// -I native). What it copies, because hostkernels.cpp has it only inside
// gen_cigar, reg2aln, gen_alt and reg2sam_se: the NM/MD walk, reg2aln's tail after its ladder, and the
// order in which gen_alt and reg2sam_se call reg2aln (walk_read).
// C ABI, called from Python via ctypes (align/native.py SePlan).

#include "hostkernels.cpp"

namespace fin {
namespace split {

// One reg2aln call: read `read`'s region `reg` (an index into the plan's
// regions of that read), its coordinates and reg2aln's first band
struct Job {
  int32_t read, reg, qb, qe, w2, truesc;
  int64_t rb, re;
  bool card;  // gen_cigar would run the DP (else the host's, at once)
};

struct Plan {
  Opts o;
  Ref ref;
  int8_t mat[25];
  int64_t n_processed;
  const uint8_t* qcodes;
  const int64_t* qoff;
  std::vector<std::vector<Reg>> regs;  // per read, as reg2sam_se takes them
  std::vector<Job> jobs;
  std::vector<CigRes> host;  // the host's result of a job, where it ran
  std::vector<uint8_t> on_host;
  std::string sam;
  std::vector<int64_t> off;
};

// reg2aln returns at once, without gen_cigar, for these
inline bool unmapped(const Reg* ar) { return ar->rb < 0 || ar->re < 0; }

// The reg2aln calls of one read, in the order gen_alt (xa(i, r): region i
// as an XA hit of r) and then reg2sam_se (sam(k)) make them: the choices
// only, copied from those two functions.
template <class Xa, class Sam>
static void walk_read(const Opts& o, const std::vector<Reg>& regs, Xa xa,
                      Sam sam) {
  const size_t n = regs.size();
  if (!(o.flag & 0x8 /*MEM_F_ALL*/)) {
    auto pri_idx = [&](size_t i) -> int64_t {
      int32_t k = regs[i].secondary_all;
      if (k >= 0 &&
          (double)regs[i].score >= (double)regs[k].score * o.XA_drop_ratio)
        return k;
      return -1;
    };
    std::vector<int64_t> cnt(n, 0);
    std::vector<bool> has_alt(n, false);
    int64_t tot = 0;
    for (size_t i = 0; i < n; ++i) {
      int64_t r = pri_idx(i);
      if (r >= 0) {
        cnt[r] += 1;
        ++tot;
        if (regs[i].is_alt) has_alt[r] = true;
      }
    }
    if (tot != 0) {
      for (size_t i = 0; i < n; ++i) {
        int64_t r = pri_idx(i);
        if (r < 0) continue;
        if (cnt[r] > o.max_XA_hits_alt ||
            (!has_alt[r] && cnt[r] > o.max_XA_hits))
          continue;
        xa(i, (size_t)r);
      }
    }
  }
  for (size_t k = 0; k < n; ++k) {
    const Reg& p = regs[k];
    if (p.score < o.T) continue;
    if (p.secondary >= 0 && (p.is_alt || !(o.flag & 0x8))) continue;
    if (p.secondary >= 0 && p.secondary < kIntMax &&
        (double)p.score < (double)regs[p.secondary].score * o.drop_ratio)
      continue;
    sam(k);
  }
}

// gen_cigar's NM/MD walk over the region's (possibly reversed) query and
// reference; `clamped`: the DP branch ran, which clamps the query to 0..4
// before the walk
static void md_walk(const Ref& ref, const uint8_t* query, int32_t l_query,
                    int64_t rb, int64_t re, bool clamped, CigRes& out) {
  std::vector<uint8_t> rseq(ref.text + rb, ref.text + re);
  std::vector<uint8_t> q(query, query + l_query);
  if (rb >= ref.l_pac) {
    std::reverse(q.begin(), q.end());
    std::reverse(rseq.begin(), rseq.end());
  }
  if (clamped)
    for (auto& c : q)
      if (c > 4) c = 4;
  const char* int2base = rb < ref.l_pac ? "ACGTN" : "TGCAN";
  std::string md;
  int32_t x = 0, y = 0, u = 0;
  int64_t n_mm = 0, n_gap = 0;
  const size_t nc = out.cig.size();
  char tmp[24];
  for (size_t k = 0; k < nc; ++k) {
    int32_t op = out.cig[k] & 0xF;
    int32_t ln = (int32_t)(out.cig[k] >> 4);
    if (op == 0) {
      int32_t prev = -1;
      for (int32_t i = 0; i < ln; ++i) {
        if (q[x + i] != rseq[y + i]) {
          md.append(tmp, snprintf(tmp, sizeof tmp, "%d", u + i - prev - 1));
          uint8_t rc = rseq[y + i];
          md.push_back(int2base[rc > 4 ? 4 : rc]);
          u = 0;
          prev = i;
          ++n_mm;
        }
      }
      u += ln - 1 - prev;
      x += ln;
      y += ln;
    } else if (op == 2) {
      if (k > 0 && k + 1 < nc) {
        md.append(tmp, snprintf(tmp, sizeof tmp, "%d", u));
        md.push_back('^');
        for (int32_t i = 0; i < ln; ++i) {
          uint8_t rc = rseq[y + i];
          md.push_back(int2base[rc > 4 ? 4 : rc]);
        }
        u = 0;
        n_gap += ln;
      }
      y += ln;
    } else if (op == 1) {
      x += ln;
      n_gap += ln;
    }
  }
  md.append(tmp, snprintf(tmp, sizeof tmp, "%d", u));
  out.NM = (int32_t)(n_mm + n_gap);
  out.md = std::move(md);
}

// reg2aln's first band for region ar (before its ladder)
static int32_t first_band(const Opts& o, const Reg& ar) {
  int32_t w2 = std::max(
      infer_bw(ar.qe - ar.qb, ar.re - ar.rb, ar.truesc, o.a, o.o_del,
               o.e_del),
      infer_bw(ar.qe - ar.qb, ar.re - ar.rb, ar.truesc, o.a, o.o_ins,
               o.e_ins));
  if (w2 > o.w) w2 = std::min((int64_t)w2, (int64_t)ar.w);
  if (w2 > (o.w << 2)) w2 = (int32_t)(o.w << 2);
  return w2;
}

// reg2aln's band ladder on the host, with NM and MD: from its first band,
// or, with `first_sc`, from the second, after a first call that scored
// first_sc
static CigRes ladder(const Opts& o, const Ref& ref, const uint8_t* codes,
                     const Job& jb, const int32_t* first_sc) {
  int32_t w2 = jb.w2, last_sc = -(1 << 30), i = 0;
  if (first_sc != nullptr) {
    last_sc = *first_sc;
    w2 <<= 1;
    i = 1;
  }
  CigRes g;
  for (;;) {
    if (w2 > (o.w << 2)) w2 = (int32_t)(o.w << 2);
    g = gen_cigar(o, ref, w2, codes + jb.qb, jb.qe - jb.qb, jb.rb, jb.re,
                  true);
    if (g.score == last_sc || w2 == (o.w << 2)) break;
    last_sc = g.score;
    w2 <<= 1;
    ++i;
    if (!(i < 3 && g.score < jb.truesc - o.a)) break;
  }
  return g;
}

// reg2aln after its ladder, on the CIGAR g of region ar (copied from
// reg2aln, whose ladder is the plan's job, the card's and the host's)
static Aln reg2aln_from(const Opts& o, const Ref& ref, int32_t l_query,
                        const Reg* ar, CigRes& g) {
  Aln a;
  int32_t qb = ar->qb, qe = ar->qe;
  int64_t rb = ar->rb, re = ar->re;
  a.mapq = ar->secondary < 0 ? approx_mapq(o, *ar) : 0;
  if (ar->secondary >= 0) a.flag |= 0x100;
  a.NM = g.NM;
  a.md = std::move(g.md);
  int64_t dp = rb < ref.l_pac ? rb : re - 1;
  bool is_rev = dp >= ref.l_pac;
  int64_t pos = is_rev ? (ref.l_pac << 1) - 1 - dp : dp;
  a.is_rev = is_rev;
  std::vector<uint32_t> cig;
  if (g.has) cig = std::move(g.cig);
  if (!cig.empty()) {
    if ((cig.front() & 0xF) == 2) {
      pos += cig.front() >> 4;
      cig.erase(cig.begin());
    } else if ((cig.back() & 0xF) == 2) {
      cig.pop_back();
    }
  }
  if (qb != 0 || qe != l_query) {
    int32_t clip5 = a.is_rev ? l_query - qe : qb;
    int32_t clip3 = a.is_rev ? qb : l_query - qe;
    if (clip5) cig.insert(cig.begin(), ((uint32_t)clip5 << 4) | 3);
    if (clip3) cig.push_back(((uint32_t)clip3 << 4) | 3);
  }
  a.cigar = std::move(cig);
  a.n_cigar = (int32_t)a.cigar.size();
  a.rid = pos2rid(ref, pos);
  a.pos = pos - ref.ctg_off[a.rid];
  a.score = ar->score;
  a.sub = std::max(ar->sub, ar->csub);
  a.is_alt = ar->is_alt;
  a.alt_sc = ar->alt_sc;
  return a;
}

// reg2sam_se of one read on the plan's results, job `*cur` on; false when a
// job does not belong to the region that reg2aln is called for
static bool emit_read(Plan& p, int32_t li, const int32_t* res,
                      int32_t stride, const char* name, int64_t name_len,
                      const char* qual, int64_t qual_len, const char* comment,
                      int64_t comment_len, const char* rg_id, int32_t rg_len,
                      size_t* cur) {
  const Opts& o = p.o;
  const Ref& ref = p.ref;
  std::vector<Reg>& regs = p.regs[li];
  const uint8_t* codes = p.qcodes + p.qoff[li];
  const int64_t l_seq = p.qoff[li + 1] - p.qoff[li];
  const int32_t l_query = (int32_t)l_seq;
  bool ok = true;
  auto take = [&](size_t k) -> Aln {
    const Reg* ar = &regs[k];
    if (unmapped(ar)) return reg2aln(o, ref, l_query, codes, ar);
    const size_t j = (*cur)++;
    if (j >= p.jobs.size() || p.jobs[j].read != li ||
        p.jobs[j].reg != (int32_t)k) {
      ok = false;
      return Aln();
    }
    const Job& jb = p.jobs[j];
    CigRes g;
    if (p.on_host[j]) {
      g = std::move(p.host[j]);
    } else {
      const int32_t* r = res + (size_t)j * stride;
      g.has = true;
      g.score = r[0];
      g.cig.assign(reinterpret_cast<const uint32_t*>(r + 2),
                   reinterpret_cast<const uint32_t*>(r + 2 + r[1]));
      md_walk(ref, codes + jb.qb, jb.qe - jb.qb, jb.rb, jb.re,
              !(jb.qe - jb.qb == jb.re - jb.rb && jb.w2 == 0), g);
    }
    return reg2aln_from(o, ref, l_query, ar, g);
  };

  const bool use_xa = !(o.flag & 0x8 /*MEM_F_ALL*/);
  std::vector<std::string> XA;
  std::vector<bool> has_XA;
  if (use_xa) {
    XA.assign(regs.size(), std::string());
    has_XA.assign(regs.size(), false);
  }
  std::vector<Aln> aa;
  char tmp[48];
  walk_read(
      o, regs,
      [&](size_t i, size_t r) {  // gen_alt's XA hit
        Aln t = take(i);
        if (!ok) return;
        std::string& s = XA[r];
        s.append(ref.ctg_names + ref.ctg_name_off[t.rid],
                 ref.ctg_name_off[t.rid + 1] - ref.ctg_name_off[t.rid]);
        s.push_back(',');
        s.push_back(t.is_rev ? '-' : '+');
        s.append(tmp,
                 snprintf(tmp, sizeof tmp, "%lld,", (long long)(t.pos + 1)));
        for (uint32_t c : t.cigar) {
          s.append(tmp, snprintf(tmp, sizeof tmp, "%u", c >> 4));
          s.push_back(kOpChrXA[c & 0xF]);
        }
        s.append(tmp, snprintf(tmp, sizeof tmp, ",%d;", t.NM));
        has_XA[r] = true;
      },
      [&](size_t k) {  // reg2sam_se's record
        Reg& pr = regs[k];
        Aln q = take(k);
        if (!ok) return;
        if (use_xa && has_XA[k]) {
          q.XA = XA[k];
          q.has_XA = true;
        }
        q.flag |= (int32_t)o.extra_flag;
        if (pr.secondary >= 0) q.sub = -1;
        if (!aa.empty() && pr.secondary < 0)
          q.flag |= (o.flag & 0x10 /*MEM_F_NO_MULTI*/) ? 0x10000 : 0x800;
        if (!(o.flag & 0x1000 /*MEM_F_KEEP_SUPP_MAPQ*/) && !aa.empty() &&
            !pr.is_alt && q.mapq > aa[0].mapq)
          q.mapq = aa[0].mapq;
        aa.push_back(std::move(q));
      });
  if (!ok) return false;
  std::string& out = p.sam;
  if (aa.empty()) {
    Aln t = reg2aln(o, ref, l_query, codes, nullptr);
    t.flag |= (int32_t)o.extra_flag;
    std::vector<Aln> one;
    one.push_back(std::move(t));
    aln2sam_se(o, ref, name, name_len, codes, l_seq, qual, qual_len, comment,
               comment_len, rg_id, rg_len, 1, one, 0, out);
    out.push_back('\n');
    return true;
  }
  for (size_t k = 0; k < aa.size(); ++k) {
    aln2sam_se(o, ref, name, name_len, codes, l_seq, qual, qual_len, comment,
               comment_len, rg_id, rg_len, aa.size(), aa, k, out);
    out.push_back('\n');
  }
  return true;
}

}  // namespace split
}  // namespace fin

extern "C" {

// The plan of a batch: finalize_se_c's arguments up to dopt (without the
// names, qualities and comments, which fin_se_emit_c takes). Every array
// the plan points into (the codes, the text, the contig tables) must live
// until fin_se_free_c. Returns the plan and sets *n_jobs.
void* fin_se_plan_c(
    int32_t R, const int32_t* reg_off, const int64_t* rb, const int64_t* re,
    const int32_t* qb, const int32_t* qe, const int32_t* rid,
    const int32_t* score, const int32_t* truesc, const int32_t* sub,
    const int32_t* csub, const int32_t* w_arr, const int32_t* seedcov,
    const double* frac_rep, const uint8_t* reg_is_alt, const uint8_t* qcodes,
    const int64_t* qoff, const uint8_t* text, int64_t l_pac, int32_t n_ctg,
    const int64_t* ctg_off, const char* ctg_names,
    const int64_t* ctg_name_off, const uint8_t* ctg_is_alt,
    const int8_t* mat, const int64_t* iopt, const double* dopt,
    int64_t* n_jobs) {
  using fin::split::Job;
  auto* p = new fin::split::Plan();
  std::memcpy(p->mat, mat, sizeof p->mat);
  fin::Opts& o = p->o;
  o.mat = p->mat;
  o.o_del = iopt[0];
  o.e_del = iopt[1];
  o.o_ins = iopt[2];
  o.e_ins = iopt[3];
  o.a = iopt[4];
  o.b = iopt[5];
  o.T = iopt[6];
  o.w = iopt[7];
  o.max_chain_gap = iopt[8];
  o.min_seed_len = iopt[9];
  o.flag = iopt[10];
  o.max_XA_hits = iopt[11];
  o.max_XA_hits_alt = iopt[12];
  o.mapQ_coef_fac = iopt[13];
  o.extra_flag = iopt[14];
  p->n_processed = iopt[15];
  o.mask_level = dopt[0];
  o.mask_level_redun = dopt[1];
  o.drop_ratio = dopt[2];
  o.XA_drop_ratio = dopt[3];
  o.mapQ_coef_len = dopt[4];
  fin::Ref& ref = p->ref;
  ref.text = text;
  ref.l_pac = l_pac;
  ref.n_ctg = n_ctg;
  ref.ctg_off = ctg_off;
  ref.ctg_names = ctg_names;
  ref.ctg_name_off = ctg_name_off;
  ref.ctg_is_alt = ctg_is_alt;
  p->qcodes = qcodes;
  p->qoff = qoff;
  p->regs.resize(R);
  for (int32_t li = 0; li < R; ++li) {
    std::vector<fin::Reg>& regs = p->regs[li];
    for (int32_t g = reg_off[li]; g < reg_off[li + 1]; ++g) {
      if (qe[g] <= qb[g]) continue;
      fin::Reg r;
      r.rb = rb[g];
      r.re = re[g];
      r.qb = qb[g];
      r.qe = qe[g];
      r.rid = rid[g];
      r.score = score[g];
      r.truesc = truesc[g];
      r.sub = sub[g];
      r.csub = csub[g];
      r.sub_n = 0;
      r.alt_sc = 0;
      r.w = w_arr[g];
      r.seedcov = seedcov[g];
      r.secondary = -1;
      r.secondary_all = -1;
      r.n_comp = 1;
      r.hash = 0;
      r.frac_rep = frac_rep[g];
      r.is_alt = reg_is_alt[g] != 0;
      regs.push_back(r);
    }
    const uint8_t* codes = qcodes + qoff[li];
    fin::sort_dedup_patch(o, ref, codes, regs);
    for (auto& r : regs)
      if (r.rid >= 0 && ctg_is_alt[r.rid]) r.is_alt = true;
    fin::mark_primary(o, regs, p->n_processed + li);
    if (o.flag & 0x800 /*MEM_F_PRIMARY5*/) fin::reorder_primary5(o, regs);
    auto add = [&](size_t k) {
      const fin::Reg& r = regs[k];
      if (fin::split::unmapped(&r)) return;
      Job jb;
      jb.read = li;
      jb.reg = (int32_t)k;
      jb.qb = r.qb;
      jb.qe = r.qe;
      jb.rb = r.rb;
      jb.re = r.re;
      jb.w2 = fin::split::first_band(o, r);
      jb.truesc = r.truesc;
      // gen_cigar returns without a CIGAR for these
      jb.card = r.qe > r.qb && r.rb < r.re &&
                !(r.rb < l_pac && r.re > l_pac);
      p->jobs.push_back(jb);
    };
    fin::split::walk_read(
        o, regs, [&](size_t i, size_t) { add(i); }, [&](size_t k) { add(k); });
  }
  p->host.resize(p->jobs.size());
  p->on_host.assign(p->jobs.size(), 0);
  *n_jobs = (int64_t)p->jobs.size();
  return p;
}

// The plan's jobs as sw_global_coord takes them, (5, n_jobs) int64: rb,
// the query's first code in the batch's codes, qlen (0 for a job that is
// the host's at once), rlen, the first band
void fin_se_jobs_c(void* h, int64_t* out) {
  const auto* p = static_cast<fin::split::Plan*>(h);
  const size_t N = p->jobs.size();
  for (size_t j = 0; j < N; ++j) {
    const auto& jb = p->jobs[j];
    out[j] = jb.rb;
    out[N + j] = p->qoff[jb.read] + jb.qb;
    out[2 * N + j] = jb.card ? jb.qe - jb.qb : 0;
    out[3 * N + j] = jb.re - jb.rb;
    out[4 * N + j] = jb.w2;
  }
}

// gen_cigar on the host for every job whose result the card left to it
// (a count of runs below 0, or no DP to run), and reg2aln's ladder on from
// the card's first band where its score calls for a wider band. res: the
// kernel's (n_jobs, stride) int32 results. Returns how many jobs it ran.
int64_t fin_se_cigar_host_c(void* h, const int32_t* res, int32_t stride) {
  auto* p = static_cast<fin::split::Plan*>(h);
  const fin::Opts& o = p->o;
  int64_t n = 0;
  for (size_t j = 0; j < p->jobs.size(); ++j) {
    const auto& jb = p->jobs[j];
    const uint8_t* codes = p->qcodes + p->qoff[jb.read];
    const int32_t* r = res + j * stride;
    const int32_t* first = nullptr;
    if (jb.card && r[1] >= 0) {
      if (jb.w2 == (o.w << 2) || r[0] >= jb.truesc - o.a) continue;
      first = r;
    }
    p->host[j] = fin::split::ladder(o, p->ref, codes, jb, first);
    p->on_host[j] = 1;
    ++n;
  }
  return n;
}

// The SAM text of the batch into the plan, a block a read, after
// fin_se_cigar_host_c. Returns its bytes (fin_se_copy_c hands it over), or
// -1 when the jobs do not follow the plan's regions.
int64_t fin_se_emit_c(void* h, const int32_t* res, int32_t stride,
                      const char* names, const int64_t* name_off,
                      const char* quals, const int64_t* qual_off,
                      const char* comments, const int64_t* comm_off,
                      const char* rg_id, int32_t rg_len) {
  auto* p = static_cast<fin::split::Plan*>(h);
  const int32_t R = (int32_t)p->regs.size();
  p->sam.clear();
  p->off.assign(R + 1, 0);
  size_t cur = 0;
  for (int32_t li = 0; li < R; ++li) {
    if (!fin::split::emit_read(
            *p, li, res, stride, names + name_off[li],
            name_off[li + 1] - name_off[li], quals + qual_off[li],
            qual_off[li + 1] - qual_off[li], comments + comm_off[li],
            comm_off[li + 1] - comm_off[li], rg_id, rg_len, &cur))
      return -1;
    p->off[li + 1] = (int64_t)p->sam.size();
  }
  if (cur != p->jobs.size()) return -1;
  return (int64_t)p->sam.size();
}

// The emitted text into buf (its bytes) and each read's block offsets into
// out_off (R + 1)
void fin_se_copy_c(void* h, char* buf, int64_t* out_off) {
  const auto* p = static_cast<fin::split::Plan*>(h);
  std::memcpy(buf, p->sam.data(), p->sam.size());
  for (size_t i = 0; i < p->off.size(); ++i) out_off[i] = p->off[i];
}

void fin_se_free_c(void* h) { delete static_cast<fin::split::Plan*>(h); }

}  // extern "C"
