"""The single-end finalize with its CIGARs from the card.

finalize_se_c (align/native.py finalize_se_native) spends most of its time
in one loop, the banded global alignment with traceback that
bwa_gen_cigar2 runs for every region the SAM names. Here that loop runs on
the card, once a batch, and the C++ keeps the rest (native.SePlan):

  plan    (after the batch is flattened, as finalize_se_native does)
          dedup, primary marking and the regions reg2aln will align, as a
          job table with reg2aln's first band        (``finalize.native``)
  card    one upload of the jobs, the scoring matrix and the read codes,
          one sw_global_coord launch over the jobs, one readback
                                                     (``finalize.cigar``)
  host    gen_cigar for the jobs the kernel flagged and reg2aln's band
          ladder where the card's score calls for it
                         (``finalize.cigar_host``, in ``finalize.native``)
  emit    NM, MD, XA and the SAM text, byte for byte finalize_se_c's,
          decoded into a string a read after the span (``finalize.native``)

The Aligner's single-end finalize (pipeline.Aligner._finalize_se) is this
path on every device. On the CPU the card's step flags every job
(sw_global.cigars) and the host's step runs gen_cigar on each, as
finalize_se_c does; the kernel's plain version (sw_global.align_jobs) is
held against it in the tests.
"""

from __future__ import annotations

from bwameme_tpu_torch.align import native
from bwameme_tpu_torch.ops import sw_global
from bwameme_tpu_torch.utils.timer import tstage

# the stage of the host's share of the CIGARs (the benchmark reads it)
CIGAR_HOST = "finalize.cigar_host"


def finalize_se_split(opt, bns, text, text32, recs, regs, rg_id,
                      n_processed) -> list[str]:
    """SAM blocks of a single-end batch, a string a read, as
    native.finalize_se_native writes them; the DP of its CIGARs on
    text32's device. ``regs``: a RegTable or AlnReg lists per read."""
    with native.SePlan(opt, bns, text, recs, regs, n_processed) as plan:
        with tstage("finalize.native"):
            jobs = plan.plan()
        with tstage("finalize.cigar"):
            res = sw_global.cigars(text32, plan.f["qcodes"], jobs, opt,
                                   int(bns.l_pac))
        with tstage("finalize.native"):
            with tstage(CIGAR_HOST):
                n_host = plan.cigar_host(res)
            raw, off = plan.emit(res, rg_id)
    sw_global.stats.jobs += jobs.shape[1]
    sw_global.stats.host += n_host
    return [raw[off[i]: off[i + 1]].decode() for i in range(len(recs))]
