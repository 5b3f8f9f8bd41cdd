"""Host microseconds a read in the port's seed.unpacked stage (nested in
seed.finish): the batches that outgrew the packed SMEM buffer, fetched as
whole slot planes with an Smem an emission, and the FM-index's reruns of
reads that outgrew their slots. 0.0 where seeding ran and the fallback did
not; None where the program names no such stage (pipeline.UNPACKED)."""

from pbench import readers


def read(run):
    from bwameme_tpu_torch import pipeline

    stage = getattr(pipeline, "UNPACKED", None)
    if stage is None or run.kind != "se" or "seed.finish" not in run.tprof:
        return None
    return readers.per_unit_us(run, run.tprof.get(stage, 0.0))
