"""Multi-process alignment over torch.distributed: the dp axis mapped to
processes.

Port of bwameme_tpu/parallel/multihost.py. Each process holds the whole
index, its per-suffix planes in rank blocks over its own ``shards`` cards
(the JAX package's local ("idx",) mesh of _LOCAL_DEVICES devices a
process), and aligns one contiguous slice of every chunk. The launcher
scatters the chunk as one FASTQ file a process and gathers the SAM blocks
in process order.

``init_process_group`` forms the group on a free local port; one global
``all_reduce`` of each process's card count proves the collectives work and
that the processes hold n_procs * shards cards in all (the JAX package's
``device_count() == n_procs * _LOCAL_DEVICES``). Alignment itself needs
none, reads being independent, with one exception: paired-end insert-size
statistics are chunk-wide (the reference's mem_pestat over the whole chunk,
src/bwamem_pair.cpp:81-149). Each process takes its local observations
(pairing.pestat_isize), all processes all-gather them, and the statistics
come from the union (pairing.pestat_from_isize): the one distributed
computation. Each process's reads take their global offset in the chunk
(the tie-breaking hash and the pair ids), so the gathered SAM equals a
single-process run byte for byte.

The backend is explicit (``process_cards``):
- ``nccl``: process p holds cards [p * shards, (p + 1) * shards), the dp
  rows of parallel/dp.make_dp_mesh, one block a card; its kernels and
  collectives run on the first of them. Fewer visible cards than
  n_procs * shards raises; nothing falls back to gloo or the CPU.
- ``gloo``: the collectives run on the host and each process's blocks are
  ``shards`` copies of its ``device`` (processes may share cuda:0). Each
  process's mode ladder budgets the card's memory as if it were alone
  (index/device.choose_mode): two processes on one card do not see each
  other's planes.

    python -m bwameme_tpu_torch.parallel.multihost [n_procs] [backend] \
        [device] [shards]

(by default 2 processes, gloo, on the card, 1 block; ``2 gloo cpu 2`` runs
on the CPU, ``2 nccl cuda 2`` needs four cards).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    """A free TCP port for the group's rendezvous (a fixed port collides
    when two runs execute at the same time)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _workload():
    from bwameme_tpu_torch.parallel.dryrun import _build_workload

    return _build_workload(np.random.default_rng(0))


def _pe_options():
    from bwameme_tpu_torch.utils.config import MEM_F_PE, MemOptions

    opt = MemOptions()
    opt.flag |= MEM_F_PE
    return opt


def _gathered_pestat(opt, l_pac, deduped, comm: torch.device):
    """Chunk-wide insert-size statistics: every process's per-orientation
    observations all-gathered (first the counts, then the observations
    padded to the largest count, as int64 on ``comm``, the device the
    backend's collectives take) and merged in process order, so that the
    merged lists equal the single-process chunk's element for element."""
    import torch.distributed as dist

    from bwameme_tpu_torch.align import pairing

    local = pairing.pestat_isize(opt, l_pac, deduped)
    n = dist.get_world_size()
    counts = torch.tensor([len(x) for x in local], dtype=torch.int64,
                          device=comm)
    all_counts = [torch.empty_like(counts) for _ in range(n)]
    dist.all_gather(all_counts, counts)
    all_counts = torch.stack(all_counts).cpu().numpy()
    mx = max(1, int(all_counts.max()))
    pad = np.zeros((4, mx), np.int64)
    for d in range(4):
        pad[d, : len(local[d])] = local[d]
    pad = torch.from_numpy(pad).to(comm)
    gathered = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(gathered, pad)
    gathered = torch.stack(gathered).cpu().numpy()
    merged = [[int(v) for p in range(n)
               for v in gathered[p, d, : all_counts[p, d]]]
              for d in range(4)]
    return pairing.pestat_from_isize(merged)


def process_cards(backend: str, pid: int, n_procs: int, device: str,
                  shards: int) -> list[torch.device]:
    """The devices that hold process ``pid``'s rank blocks, one a block:
    under nccl its row of make_dp_mesh(n_procs, shards) over the visible
    cards, under gloo ``shards`` copies of ``device``."""
    if backend == "nccl":
        from bwameme_tpu_torch.parallel.dp import make_dp_mesh

        need, have = n_procs * shards, torch.cuda.device_count()
        if have < need:
            raise RuntimeError(f"nccl: {n_procs} processes of {shards} "
                               f"card(s) each need {need} cards, {have} "
                               "visible")
        return make_dp_mesh(n_procs, shards)[pid]
    if backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * shards


def worker_main(pid: int, n_procs: int, workdir: str, port: int,
                backend: str, device: str, shards: int) -> None:
    import torch.distributed as dist

    from bwameme_tpu_torch.io.fastq import _iter_records
    from bwameme_tpu_torch.pipeline import Aligner
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
    from bwameme_tpu_torch.utils.config import MemOptions

    cards = process_cards(backend, pid, n_procs, device, shards)
    dev = cards[0]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # the plain versions work on small tensors: one thread a process
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n_procs, rank=pid)
    try:
        comm = dev if backend == "nccl" else torch.device("cpu")
        total = torch.tensor([len(cards)], dtype=torch.int64, device=comm)
        dist.all_reduce(total)
        if int(total) != n_procs * shards:
            raise RuntimeError(f"the processes hold {int(total)} cards, not "
                               f"{n_procs} x {shards}")
        with open(os.path.join(workdir, f"cards_{pid}"), "w") as f:
            f.write(f"{int(total)} {' '.join(map(str, cards))}")

        idx, _, _ = _workload()     # each process builds its own copy
        opt = MemOptions()
        eng = DeviceSeedingEngine(idx, opt, lanes=128, device=dev,
                                  shards=cards if shards > 1 else None)

        def run(tag, opt):
            reads = list(_iter_records(os.path.join(
                workdir, f"chunk_{tag}_{pid}.fq")))
            with open(os.path.join(workdir, f"base_{tag}_{pid}")) as f:
                base = int(f.read())
            # base: the slice's global offset, for hash ties and pair ids
            al = Aligner(idx, opt, seeding_engine=eng, device=dev)
            recs = al.encode(reads)
            if tag == "se":
                return al.sam_se(recs, al.regions(recs), base)
            deduped = al.pe_regions(recs)
            pes = _gathered_pestat(opt, idx.bns.l_pac, deduped, comm)
            return al.sam_pe(recs, deduped, pes, base)

        for tag, o in (("se", opt), ("pe", _pe_options())):
            sam = run(tag, o)
            with open(os.path.join(workdir, f"out_{tag}_{pid}.sam"),
                      "w") as f:
                f.write("".join(sam))
    finally:
        dist.destroy_process_group()


def _write_fastq(path: str, reads) -> None:
    with open(path, "w") as f:
        for r in reads:
            f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")


def _scatter(workdir: str, reads, tag: str, n_procs: int,
             even: bool) -> None:
    """One FASTQ file and the slice's global offset a process, over the
    data-parallel rows' slices (pair-aligned for interleaved pairs)."""
    from bwameme_tpu_torch.parallel.dp import slices

    for pid, (b, e) in enumerate(slices(len(reads), n_procs, even)):
        _write_fastq(os.path.join(workdir, f"chunk_{tag}_{pid}.fq"),
                     reads[b:e])
        with open(os.path.join(workdir, f"base_{tag}_{pid}"), "w") as f:
            f.write(str(b))


def run_multihost(n_procs: int = 2, backend: str = "gloo",
                  device: str = "cuda", shards: int = 1,
                  workdir: str | None = None,
                  timeout: float = 600.0) -> tuple[str, str]:
    """Launches n_procs worker processes on the shared workload, scatters
    its single-end reads and pairs, and returns the gathered SAM records
    (single-end, paired-end), each one string in process order. Each worker
    writes ``cards_{pid}`` into ``workdir``: the all-reduced card count and
    its own devices."""
    if backend == "nccl":
        process_cards(backend, 0, n_procs, device, shards)
    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="bwameme_mh_")
    _, se_reads, pe_reads = _workload()
    _scatter(workdir, se_reads, "se", n_procs, even=False)
    _scatter(workdir, pe_reads, "pe", n_procs, even=True)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bwameme_tpu_torch.parallel.multihost",
         "--worker", str(pid), str(n_procs), workdir, str(port), backend,
         device, str(shards)], cwd=REPO) for pid in range(n_procs)]
    t0 = time.time()
    try:
        for p in procs:
            rc = p.wait(timeout=max(10.0, timeout - (time.time() - t0)))
            if rc != 0:
                raise RuntimeError(f"a worker exited {rc}")
    finally:
        # a timeout or a failed worker must not leave the others running
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for tag in ("se", "pe"):
        parts = []
        for pid in range(n_procs):
            with open(os.path.join(workdir, f"out_{tag}_{pid}.sam")) as f:
                parts.append(f.read())
        out.append("".join(parts))
    if own_dir:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return out[0], out[1]


def single_process(device: str = "cuda") -> tuple[str, str]:
    """The same workload aligned by one process with the device engine on
    ``device``: the SAM records (single-end, paired-end)."""
    from bwameme_tpu_torch.pipeline import Aligner
    from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
    from bwameme_tpu_torch.utils.config import MemOptions

    idx, se_reads, pe_reads = _workload()
    opt = MemOptions()
    eng = DeviceSeedingEngine(idx, opt, lanes=128, device=device)
    se = Aligner(idx, opt, seeding_engine=eng,
                 device=device).align_batch(se_reads)
    pe = Aligner(idx, _pe_options(), seeding_engine=eng,
                 device=device).align_pairs(pe_reads)
    return "".join(se), "".join(pe)


def main(argv) -> int:
    n_procs = int(argv[0]) if argv else 2
    backend = argv[1] if len(argv) > 1 else "gloo"
    device = argv[2] if len(argv) > 2 else "cuda"
    shards = int(argv[3]) if len(argv) > 3 else 1
    t0 = time.time()
    got = run_multihost(n_procs, backend, device, shards)
    want = single_process(device if backend == "gloo" else "cuda:0")
    for what, g, w in zip(("single-end", "paired-end"), got, want):
        if g != w:
            print(f"[multihost] {what} SAM differs from one process's",
                  file=sys.stderr)
            return 1
    where = (f"{shards} card(s) each" if backend == "nccl"
             else f"{shards} block(s) on {device}")
    print(f"[multihost] OK: {n_procs} processes ({backend}, {where}), "
          f"{got[0].count(chr(10))} SE + {got[1].count(chr(10))} PE records "
          f"byte-identical in {time.time() - t0:.0f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        a = sys.argv[2:]
        worker_main(int(a[0]), int(a[1]), a[2], int(a[3]), a[4], a[5],
                    int(a[6]))
    else:
        sys.exit(main(sys.argv[1:]))
