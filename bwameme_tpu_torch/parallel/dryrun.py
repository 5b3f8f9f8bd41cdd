"""Multi-device dry run: the whole mem pipeline over an index sharded by
rank blocks, its SAM held against the single-device host-engine pipeline.

Port of bwameme_tpu/parallel/dryrun.py (``_build_workload``, ``run_dryrun``,
``_scaling_probe``; ``dryrun_multichip`` is the counterpart of
__graft_entry__.dryrun_multichip). Single-end reads and pairs go through the
sharded device engine (seeding/engine.py ``shards=``), chaining, the
extension kernel, pairing and mate rescue, and finalization; the SAM must be
the single-device oracle's byte for byte. With four devices or more, a 2 x
n/2 data-parallel mesh (parallel/dp.py) runs the single-end reads too. The
scaling probe seeds one batch at several shard counts, which must agree.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def _build_workload(rng, n=30000, n_se=96, n_pe=32, read_len=120):
    """A 30 kbp genome with a planted 1 kbp repeat (secondary alignments and
    chain filtering get exercised), its index, n_se single-end reads (Poisson
    substitutions, every other one reverse-complemented) and n_pe pairs
    (insert 250-450, one substitution in the first mate)."""
    from bwameme_tpu_torch.index import bntseq
    from bwameme_tpu_torch.index.build import build_index
    from bwameme_tpu_torch.io.fastq import Read

    code = rng.integers(0, 4, n).astype(np.uint8)
    code[20000:21000] = code[5000:6000]
    bns = bntseq.BntSeq(
        l_pac=n, contigs=[bntseq.Contig("c", "", 0, n, 0)], ambs=[], code=code
    )
    idx = build_index(bns, rmi_bits=8)

    chars = "ACGT"

    def to_read(name, codes):
        return Read(name=name, seq="".join(chars[c] for c in codes),
                    qual="I" * len(codes), comment=None)

    se = []
    for i in range(n_se):
        a = int(rng.integers(0, n - read_len))
        c = idx.text[a: a + read_len].copy()
        for _ in range(rng.poisson(1.0)):
            p = int(rng.integers(0, read_len))
            c[p] = (c[p] + rng.integers(1, 4)) % 4
        if i % 2:
            c = (3 - c[::-1]).astype(np.uint8)
        se.append(to_read(f"s{i}", c))

    pairs = []
    for i in range(n_pe):
        a = int(rng.integers(0, n - 500))
        ins = int(rng.integers(250, 450))
        c1 = idx.text[a: a + read_len].copy()
        c2 = (3 - idx.text[a + ins - read_len: a + ins][::-1]).astype(np.uint8)
        p = int(rng.integers(0, read_len))
        c1[p] = (c1[p] + 1) % 4
        pairs.append(to_read(f"p{i}", c1))
        pairs.append(to_read(f"p{i}", c2))
    return idx, se, pairs


def _oracle(idx, se_reads, pe_reads):
    """The single-device host-engine pipeline's SAM blocks (SE, PE) and the
    options of both."""
    from bwameme_tpu_torch.pipeline import Aligner
    from bwameme_tpu_torch.utils.config import MEM_F_PE, MemOptions

    opt = MemOptions()
    opt_pe = MemOptions()
    opt_pe.flag |= MEM_F_PE
    return (Aligner(idx, opt, device="cpu").align_batch(se_reads),
            Aligner(idx, opt_pe, device="cpu").align_pairs(pe_reads),
            opt, opt_pe)


def run_dryrun(n_devices: int, devices=None) -> dict:
    """The pipeline with the index in n_devices blocks over ``devices`` (by
    default the first n_devices visible cards), SE and PE, held against the
    host-engine oracle; with four devices or more the 2 x n/2 data-parallel
    mesh on the SE reads; then the scaling probe at 1, 2 and n_devices
    shards. Raises on any difference; returns the stages' seconds and the
    probe's reads/s by shard count."""
    from bwameme_tpu_torch.parallel.dp import (DataParallelAligner,
                                               make_dp_mesh, visible_devices)
    from bwameme_tpu_torch.pipeline import Aligner
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine

    devices = list(visible_devices() if devices is None else devices)
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    devices = [torch.device(d) for d in devices[:n_devices]]
    t_start = time.time()
    idx, se_reads, pe_reads = _build_workload(np.random.default_rng(0))
    sam_se_base, sam_pe_base, opt, opt_pe = _oracle(idx, se_reads, pe_reads)
    took = {}

    t0 = time.time()
    eng = DeviceSeedingEngine(idx, opt, lanes=256, shards=devices)
    sam_se = Aligner(idx, opt, seeding_engine=eng,
                     device=devices[0]).align_batch(se_reads)
    took["se"] = time.time() - t0
    if sam_se != sam_se_base:
        raise AssertionError(f"{n_devices}-shard SE SAM != single-device SAM")
    # PE rides the same engine: seeding reads no PE flag
    t0 = time.time()
    sam_pe = Aligner(idx, opt_pe, seeding_engine=eng,
                     device=devices[0]).align_pairs(pe_reads)
    took["pe"] = time.time() - t0
    if sam_pe != sam_pe_base:
        raise AssertionError(f"{n_devices}-shard PE SAM != single-device SAM")

    if n_devices >= 4:
        t0 = time.time()
        mesh = make_dp_mesh(2, n_devices // 2, devices)
        dp = DataParallelAligner(idx, opt, mesh=mesh)
        if dp.align_batch(se_reads) != sam_se_base:
            raise AssertionError("dp-mesh SE SAM != single-device SAM")
        took["dp"] = time.time() - t0

    shard_counts = sorted({1, 2, n_devices} & set(range(1, n_devices + 1)))
    probe = _scaling_probe(idx, opt, shard_counts, devices,
                           reuse={n_devices: eng})
    took["all"] = time.time() - t_start
    print(f"[dryrun] OK: the pipeline on {n_devices} shards "
          f"({devices[0]}{', dp 2 x ' + str(n_devices // 2) if 'dp' in took else ''}), "
          f"SAM identical to the single-device oracle ({len(sam_se)} SE + "
          f"{len(sam_pe)} PE records) in {took['all']:.1f} s; sa_query "
          f"reads/s by shards {probe}", file=sys.stderr)
    return dict(seconds=took, probe=probe)


def _scaling_probe(idx, opt, shard_counts, devices, reuse=None) -> dict:
    """One batch seeded at each shard count (the first k devices), every
    result the same; returns {shards: reads a second} of the second run."""
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine

    rng = np.random.default_rng(1)
    reads = []
    for _ in range(64):
        a = int(rng.integers(0, idx.l_pac - 100))
        reads.append(idx.text[a: a + 100].copy())

    out, ref = {}, None
    for k in sorted(set(shard_counts) | set((reuse or {}).keys())):
        eng = (reuse or {}).get(k)
        if eng is None:
            eng = DeviceSeedingEngine(idx, opt, lanes=256,
                                      device=devices[0],
                                      shards=devices[:k] if k > 1 else None)
        got = eng.collect_smems_batch(reads)
        if ref is None:
            ref = got
        elif got != ref:
            raise AssertionError(f"{k}-shard seeding differs")
        t0 = time.time()
        eng.collect_smems_batch(reads)
        out[k] = round(len(reads) / (time.time() - t0), 1)
    return out


def dryrun_multichip(n_devices: int) -> dict:
    """run_dryrun over n_devices shards on the visible cards, one a card
    where there are enough, else cuda:0 repeated (said so on stderr)."""
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("dryrun_multichip: no CUDA device is visible")
    if cards >= n_devices:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [torch.device("cuda", 0)] * n_devices
        print(f"[dryrun] {cards} card(s) visible: the {n_devices} shards are "
              "separate allocations on cuda:0", file=sys.stderr)
    return run_dryrun(n_devices, devices)
