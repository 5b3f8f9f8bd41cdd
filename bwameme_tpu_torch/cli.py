"""Command-line interface of the port: ``index`` and ``mem``.

``python -m bwameme_tpu_torch.cli index ref.fa`` builds the same learned
index as bwameme_tpu (the port's own copy of the host code). ``python -m
bwameme_tpu_torch.cli mem PREFIX reads.fq`` aligns single-end reads, ``mem
PREFIX r1.fq r2.fq`` (or ``-p`` and one interleaved file) paired-end reads:
learned-index seeding on the device (``--engine device``, the default; the
host engine with ``--engine host``), native chaining, extension in the CUDA
kernel, for pairs mate rescue in the full-SW CUDA kernel (the serial host
SW with ``--engine host``), native finalization; it writes the same SAM
header and records as bwameme_tpu. ``-Z`` (``--backend ert``) seeds from the
ERT k-mer root and ``--backend fmi`` from the FM-index (``index -a
mem2|ert|all`` persists them). ``--profile DIR`` writes a torch.profiler
trace of the alignment into DIR (utils/timer.start_trace). ``--shards N``
splits the index's per-suffix planes in rank blocks over the first N
visible cards and ``--dp-shards D`` aligns each chunk as D contiguous slices
on D rows of them (parallel/dp.py), N x D cards in all; under
BWAMEME_PLATFORM=cpu the shards are CPU blocks. The flags are bwameme_tpu's
(bwa-mem's single-letter names).

The device is CUDA unless BWAMEME_PLATFORM=cpu asks for the CPU (where the
kernels' plain PyTorch versions run). A missing CUDA device is an error,
never a silent move to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from bwameme_tpu_torch import __version__


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bwameme-tpu-torch", add_help=False)
    p.add_argument("--help", action="help")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build the learned (P-RMI) index", add_help=False)
    pi.add_argument("--help", action="help")
    pi.add_argument("fasta")
    pi.add_argument("-a", dest="algo",
                    choices=["meme", "mem2", "ert", "all"],
                    default="meme",
                    help="index type: meme = learned P-RMI (default), "
                    "mem2 = also build the FM-index, ert = also persist the "
                    "ERT k-mer root table (otherwise rebuilt at load in "
                    "O(n)), all = everything")
    pi.add_argument("-p", "--prefix", default=None, help="index prefix")
    pi.add_argument("--rmi-bits", type=int, default=None)
    pi.add_argument("--no-isa", action="store_true",
                    help="skip the inverse suffix array (MODE<3 semantics)")

    pv = sub.add_parser("version", help="print version and build configuration",
                        add_help=False)
    pv.add_argument("--help", action="help")

    pm = sub.add_parser("mem", help="align reads, print SAM on stdout", add_help=False)
    pm.add_argument("--help", action="help")
    pm.add_argument("prefix", help="index prefix (from `index`)")
    pm.add_argument("reads1")
    pm.add_argument("reads2", nargs="?", default=None)
    pm.add_argument("-t", type=int, default=1, help="threads (accepted for "
                    "compatibility; device batching replaces host threads)")
    pm.add_argument("-k", type=int, default=None, help="min seed length")
    pm.add_argument("-w", type=int, default=100, help="band width")
    pm.add_argument("-d", type=int, default=None, help="Z-dropoff")
    pm.add_argument("-r", type=float, default=None, help="reseed trigger")
    pm.add_argument("-c", type=int, default=500, help="max occurrences")
    pm.add_argument("-A", type=int, default=None, help="match score")
    pm.add_argument("-B", type=int, default=None, help="mismatch penalty")
    pm.add_argument("-O", type=int, default=None, help="gap open penalty")
    pm.add_argument("-E", type=int, default=None, help="gap extension penalty")
    pm.add_argument("-L", type=int, default=None, help="clipping penalty")
    pm.add_argument("-U", type=int, default=None, help="unpaired penalty")
    pm.add_argument("-T", type=int, default=None, help="min score to output")
    pm.add_argument("-K", type=int, default=None,
                    help="chunk size in bp (reproducibility knob)")
    pm.add_argument("-R", default=None, help="read group header line")
    pm.add_argument("-o", "-f", dest="outfile", default=None,
                    help="output SAM file (default: stdout)")
    pm.add_argument("-H", dest="hdr_insert", action="append", default=None,
                    help="insert STR to the SAM header (@-prefixed string "
                    "or a file of lines)")
    pm.add_argument("-C", dest="copy_comment", action="store_true",
                    help="append FASTA/FASTQ comment to SAM output")
    pm.add_argument("-x", dest="preset", default=None,
                    help="read type preset: pacbio, ont2d, intractg "
                    "(changes unset options; short-read tuning remains the "
                    "design point)")
    pm.add_argument("-I", dest="insert_spec", default=None,
                    help="mean[,std[,max[,min]]]: fix the FR insert-size "
                    "distribution instead of inferring it per chunk")
    pm.add_argument("-Y", action="store_true", help="use soft clipping for "
                    "supplementary alignments")
    pm.add_argument("-a", action="store_true", help="output all alignments")
    pm.add_argument("-5", dest="primary5", action="store_true",
                    help="always take the leftmost alignment as primary")
    pm.add_argument("-p", dest="smartpe", action="store_true",
                    help="smart pairing: reads1 is interleaved paired-end")
    pm.add_argument("-P", dest="nopairing", action="store_true",
                    help="skip pairing; mate rescue only")
    pm.add_argument("-S", dest="norescue", action="store_true",
                    help="skip mate rescue")
    pm.add_argument("-M", dest="nomulti", action="store_true",
                    help="mark shorter split hits as secondary")
    pm.add_argument("-q", dest="keepsuppmapq", action="store_true",
                    help="don't modify mapq of supplementary alignments")
    pm.add_argument("-V", dest="refhdr", action="store_true",
                    help="output the reference header in the XR tag")
    pm.add_argument("-j", dest="ignore_alt", action="store_true",
                    help="treat ALT contigs as part of the primary assembly")
    pm.add_argument("-s", dest="split_width", type=int, default=10,
                    help="reseed if there are fewer than INT hits")
    pm.add_argument("-D", dest="drop_ratio", type=float, default=0.50,
                    help="drop chains shorter than FLOAT of the longest")
    pm.add_argument("-W", dest="min_chain_weight", type=int, default=None,
                    help="discard chains with seeded bases shorter than INT")
    pm.add_argument("-m", dest="max_matesw", type=int, default=50,
                    help="perform at most INT rounds of mate rescue")
    pm.add_argument("-G", dest="max_chain_gap", type=int, default=10000,
                    help="max chaining gap")
    pm.add_argument("-N", dest="max_chain_extend", type=int,
                    default=1 << 30, help="max chain extension")
    pm.add_argument("-X", dest="mask_level", type=float, default=0.50,
                    help="mask level")
    pm.add_argument("-h", dest="xa_hits", default=None,
                    help="INT[,INT] max XA hits (non-ALT[,ALT])")
    pm.add_argument("-y", dest="max_mem_intv", type=int, default=20,
                    help="seed occurrence threshold for the 3rd round")
    pm.add_argument("-v", dest="verbose", type=int, default=3,
                    help="verbosity level")
    pm.add_argument("--engine", choices=["device", "host"], default="device")
    pm.add_argument("-7", dest="learned", action="store_true",
                    help="use the learned (P-RMI) seeding backend (default)")
    pm.add_argument("-Z", dest="ert", action="store_true",
                    help="use the ERT (k-mer-root) seeding backend")
    pm.add_argument("--backend", choices=["learned", "fmi", "ert"],
                    default="learned",
                    help="seeding backend: learned index (P-RMI, the -7 "
                    "path), FM-index (the reference's default backend), or "
                    "ERT (k-mer-root, the -Z path)")
    pm.add_argument("--batch", type=int, default=4096,
                    help="reads per device batch. The seeding kernels run "
                    "a warp a read, a design for batches of up to about 32k "
                    "reads: it keeps a small batch's chain of loads short; "
                    "at 64k reads it costs 1.4 times the card time of a "
                    "thread a read (PERF.md)")
    pm.add_argument("--profile", dest="profile_dir", default=None,
                    metavar="DIR",
                    help="write a torch.profiler trace of the alignment "
                    "into DIR (TensorBoard layout; the CPU, and the device "
                    "when the run is on the card), every stage and kernel "
                    "launch a named range")
    pm.add_argument("--mode", type=int, choices=[1, 2, 3, 4], default=None,
                    help="device memory tier of the index (reference MODE "
                    "axis), bytes a suffix narrow/wide: 4=fused rank rows "
                    "16/20, 3=positions+ktext 12/16, 2=positions+rank keys "
                    "12/16, 1=positions only 4/8; default: the fastest "
                    "that fits three quarters of the device's memory "
                    "(BWAMEME_HBM_BYTES overrides the card's size); int64 "
                    "coordinates from 2^31 suffixes on")
    pm.add_argument("--shards", type=int, default=1,
                    help="shard the suffix-array index by key range (rank "
                    "blocks) over the first N visible cards, each block "
                    "read where it lies (peer pointers across cards); 1 = "
                    "single device")
    pm.add_argument("--dp-shards", type=int, default=1,
                    help="data-parallel rows: each chunk split into N "
                    "contiguous slices, each aligned by a row of --shards "
                    "cards that holds the whole index (parallel/dp.py); 1 = "
                    "no data parallelism")
    return p


def cmd_index(args) -> int:
    from bwameme_tpu_torch.index.build import build_from_fasta, save_index

    prefix = args.prefix or args.fasta
    t0 = time.time()
    idx = build_from_fasta(
        args.fasta, with_isa=not args.no_isa, rmi_bits=args.rmi_bits
    )
    print(f"[index] built in {time.time()-t0:.1f}s: l_pac={idx.l_pac} "
          f"n_sa={idx.n_sa} rmi_bits={idx.rmi_bits} max_err={idx.max_err}",
          file=sys.stderr)
    save_index(idx, prefix)
    print(f"[index] saved to {prefix}.meme/ (+ .pac/.ann/.amb)",
          file=sys.stderr)
    if args.algo in ("mem2", "all"):
        from bwameme_tpu_torch.index.fmi_store import save_fm_index
        from bwameme_tpu_torch.index.fmindex import (build_fm_index,
                                                     write_bwt_2bit_64)

        t0 = time.time()
        fm = build_fm_index(idx.bns.code)
        save_fm_index(prefix, fm)   # uncompressed: see index/fmi_store.py
        write_bwt_2bit_64(fm, prefix)
        print(f"[index] FM-index built in {time.time()-t0:.1f}s -> "
              f"{prefix}.fmi.npz + {prefix}.bwt.2bit.64", file=sys.stderr)
    if args.algo in ("ert", "all"):
        import numpy as np

        from bwameme_tpu_torch.index.ert import build_kmer_table, pick_ert_bits

        t0 = time.time()
        bits = pick_ert_bits(idx.n_sa)
        tab = build_kmer_table(idx.key_hi, bits)
        np.savez(prefix + ".ert.npz", kmer_table=tab,
                 kmer_bits=np.int64(bits))
        print(f"[index] ERT k-mer root (K={bits}) built in "
              f"{time.time()-t0:.1f}s -> {prefix}.ert.npz", file=sys.stderr)
    return 0


def mesh_refused(args) -> str | None:
    """Why --shards/--dp-shards cannot run with the other flags, as
    bwameme_tpu.cli.cmd_mem says it (the FM-index and the host engine have
    no mesh); None when they can."""
    if args.shards < 1 or args.dp_shards < 1:
        return "--shards and --dp-shards take counts of 1 or more"
    if (args.shards > 1 or args.dp_shards > 1) and (
            args.backend == "fmi" or args.engine == "host"):
        return ("--shards/--dp-shards require the device engine with the "
                "learned or ert backend")
    return None


def shard_mesh(args, device):
    """The rows of devices of --dp-shards D x --shards N (parallel/dp.py
    make_dp_mesh) over the visible cards, or over CPU blocks on the CPU;
    None without either flag. Raises ValueError, with the message of
    bwameme_tpu.cli.cmd_mem, for fewer devices than N x D."""
    if args.shards == 1 and args.dp_shards == 1:
        return None
    from bwameme_tpu_torch.parallel.dp import make_dp_mesh, visible_devices

    need = args.shards * args.dp_shards
    devs = [device] * need if device.type == "cpu" else visible_devices()
    if len(devs) < need:
        raise ValueError(f"--dp-shards {args.dp_shards} x --shards "
                         f"{args.shards}: only {len(devs)} device(s) visible")
    return make_dp_mesh(args.dp_shards, args.shards, devs)


def mem_options(args):
    """MemOptions from the mem flags, exactly as bwameme_tpu.cli.cmd_mem
    assembles them; None for an unknown -x preset."""
    from bwameme_tpu_torch.utils.config import (
        MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NO_MULTI, MEM_F_NO_RESCUE,
        MEM_F_NOPAIRING, MEM_F_PE, MEM_F_PRIMARY5, MEM_F_REF_HDR,
        MEM_F_SMARTPE, MEM_F_SOFTCLIP, MemOptions, fill_scmat,
    )

    opt = MemOptions(
        a=args.A if args.A is not None else 1,
        b=args.B if args.B is not None else 4,
        o_del=args.O if args.O is not None else 6,
        o_ins=args.O if args.O is not None else 6,
        e_del=args.E if args.E is not None else 1,
        e_ins=args.E if args.E is not None else 1,
        w=args.w, zdrop=args.d if args.d is not None else 100,
        min_seed_len=args.k if args.k is not None else 19,
        split_factor=args.r if args.r is not None else 1.5,
        max_occ=args.c,
        pen_clip5=args.L if args.L is not None else 5,
        pen_clip3=args.L if args.L is not None else 5,
        pen_unpaired=args.U if args.U is not None else 17,
        T=args.T if args.T is not None else 30,
        split_width=args.split_width, drop_ratio=args.drop_ratio,
        min_chain_weight=(args.min_chain_weight
                          if args.min_chain_weight is not None else 0),
        max_matesw=args.max_matesw,
        max_chain_gap=args.max_chain_gap,
        max_chain_extend=args.max_chain_extend,
        mask_level=args.mask_level, max_mem_intv=args.max_mem_intv,
    )
    if args.preset:
        # read-type presets adjust UNSET options; update_a is skipped when
        # a preset is given (reference: src/fastmap.cpp:1398-1435)
        m = args.preset
        if m == "intractg":
            if args.O is None:
                opt.o_del = opt.o_ins = 16
            if args.B is None:
                opt.b = 9
            if args.L is None:
                opt.pen_clip5 = opt.pen_clip3 = 5
        elif m in ("pacbio", "pbref", "ont2d"):
            if args.O is None:
                opt.o_del = opt.o_ins = 1
            if args.E is None:
                opt.e_del = opt.e_ins = 1
            if args.B is None:
                opt.b = 1
            if args.r is None:
                opt.split_factor = 10.0
            if m == "ont2d":
                if args.min_chain_weight is None:
                    opt.min_chain_weight = 20
                if args.k is None:
                    opt.min_seed_len = 14
            else:
                if args.min_chain_weight is None:
                    opt.min_chain_weight = 40
                if args.k is None:
                    opt.min_seed_len = 17
            if args.L is None:
                opt.pen_clip5 = opt.pen_clip3 = 0
        else:
            return None
        opt.mat = fill_scmat(opt.a, opt.b)
    elif args.A is not None:
        # -A rescales every *unset* penalty/threshold (reference:
        # src/fastmap.cpp:1126-1140 update_a)
        if args.B is None:
            opt.b *= opt.a
        if args.T is None:
            opt.T *= opt.a
        if args.O is None:
            opt.o_del *= opt.a
            opt.o_ins *= opt.a
        if args.E is None:
            opt.e_del *= opt.a
            opt.e_ins *= opt.a
        if args.d is None:
            opt.zdrop *= opt.a
        if args.L is None:
            opt.pen_clip5 *= opt.a
            opt.pen_clip3 *= opt.a
        if args.U is None:
            opt.pen_unpaired *= opt.a
        opt.mat = fill_scmat(opt.a, opt.b)
    if args.xa_hits:
        parts = args.xa_hits.split(",")
        opt.max_XA_hits = int(parts[0])
        if len(parts) > 1:
            opt.max_XA_hits_alt = int(parts[1])
    for flag, bit in ((args.Y, MEM_F_SOFTCLIP), (args.a, MEM_F_ALL),
                      (args.primary5, MEM_F_PRIMARY5 | MEM_F_KEEP_SUPP_MAPQ),
                      (args.nopairing, MEM_F_NOPAIRING),
                      (args.norescue, MEM_F_NO_RESCUE),
                      (args.nomulti, MEM_F_NO_MULTI),
                      (args.keepsuppmapq, MEM_F_KEEP_SUPP_MAPQ),
                      (args.refhdr, MEM_F_REF_HDR),
                      (args.smartpe, MEM_F_SMARTPE),
                      (args.reads2 is not None or args.smartpe, MEM_F_PE)):
        if flag:
            opt.flag |= bit
    return opt


def insert_size(spec: str):
    """-I mean[,std[,max[,min]]] as the four orientations' statistics: FR
    fixed, the others failed (as bwameme_tpu.cli.cmd_mem parses it)."""
    import re

    from bwameme_tpu_torch.align.pairing import PeStat

    nums = [float(x) for x in re.split(r"[^0-9.eE+-]+", spec) if x]
    fr = PeStat(failed=0)
    fr.avg = nums[0]
    fr.std = nums[1] if len(nums) > 1 else fr.avg * 0.1
    fr.high = int(nums[2] + 0.499) if len(nums) > 2 else int(
        fr.avg + 4.0 * fr.std + 0.499)
    fr.low = int(nums[3] + 0.499) if len(nums) > 3 else max(
        int(fr.avg - 4.0 * fr.std + 0.499), 1)
    fr.low = max(fr.low, 1)
    return [PeStat(failed=1), fr, PeStat(failed=1), PeStat(failed=1)]


def select_device():
    """CUDA, or the CPU when BWAMEME_PLATFORM=cpu; None if CUDA is asked
    for and absent."""
    import torch

    if os.environ.get("BWAMEME_PLATFORM") == "cpu":
        return torch.device("cpu")
    return torch.device("cuda") if torch.cuda.is_available() else None


def ert_bits(prefix: str, idx) -> int:
    """The k-mer root's size for ``mem -Z``, as bwameme_tpu.cli.cmd_mem
    finds it: a persisted root (``index -a ert``) fixes it, else 0 (the size
    index/ert.pick_ert_bits gives). A reference-built ``.kmer_table`` beside
    the index is checked against the index's key plane and reported (its
    tree offsets have no use here)."""
    import numpy as np

    bits = 0
    if os.path.exists(prefix + ".ert.npz"):
        with np.load(prefix + ".ert.npz") as z:
            bits = int(z["kmer_bits"])
    if os.path.exists(prefix + ".kmer_table"):
        from bwameme_tpu_torch.index.ert import (load_kmer_table,
                                                 validate_reference_kmer_table)

        st = validate_reference_kmer_table(
            idx.key_hi, load_kmer_table(prefix + ".kmer_table"))
        print(f"[mem] reference .kmer_table validated: "
              f"{st['present_checked']} present + "
              f"{st['uniform_checked']} uniform k-mers, "
              f"{st['mismatches']} mismatches", file=sys.stderr)
    return bits


def fmi_engine(args, idx, opt, device, timer):
    """The FM-index seeding engine for ``--backend fmi``: the index from
    ``prefix.fmi.npz``, else from a reference ``prefix.bwt.2bit.64``, else
    built at load; the device engine (``FmiDeviceEngine``) or, with
    ``--engine host``, the scalar ``FmiHostEngine``."""
    from bwameme_tpu_torch.index import fmindex
    from bwameme_tpu_torch.seeding.fmi_engine import (FmiDeviceEngine,
                                                      FmiHostEngine)

    with timer.stage("fmi_load"):
        if os.path.exists(args.prefix + ".fmi.npz"):
            fm = fmindex.load_fm_index(args.prefix)
        elif os.path.exists(args.prefix + fmindex.CP_FILENAME_SUFFIX):
            fm = fmindex.read_bwt_2bit_64(args.prefix)
        else:
            fm = fmindex.build_fm_index(idx.bns.code)
    if args.engine == "host":
        return FmiHostEngine(idx, opt, fm=fm)
    with timer.stage("index_upload"):
        return FmiDeviceEngine(idx, opt, fm=fm, device=device)


def cmd_mem(args) -> int:
    from bwameme_tpu_torch.index.build import load_index
    from bwameme_tpu_torch.io import fastq, sam
    from bwameme_tpu_torch.utils.timer import (TPROF, StageTimer, start_trace,
                                               stop_trace)
    from bwameme_tpu_torch.pipeline import Aligner

    msg = mesh_refused(args)
    if msg:
        print(f"[mem] {msg}", file=sys.stderr)
        return 1
    if args.ert:
        args.backend = "ert"
    if args.backend == "ert" and args.engine == "host":
        print("[mem] --backend ert requires the device engine (the host "
              "oracle implements the learned/FMI contracts only)",
              file=sys.stderr)
        return 1
    opt = mem_options(args)
    if opt is None:
        print(f"[mem] unknown read type '{args.preset}'", file=sys.stderr)
        return 1
    device = select_device()
    if device is None:
        print("[mem] no CUDA device is available (set BWAMEME_PLATFORM=cpu "
              "to run the plain PyTorch path on the CPU)", file=sys.stderr)
        return 1
    try:
        mesh = shard_mesh(args, device)
    except ValueError as e:
        print(f"[mem] {e}", file=sys.stderr)
        return 1
    if mesh is not None:
        print(f"[mem] {args.dp_shards} dp row(s) x {args.shards} index "
              f"shard(s) on {', '.join(str(d) for row in mesh for d in row)}",
              file=sys.stderr)
    on_card = device.type == "cuda"
    if args.profile_dir and on_card:
        import torch

        if (torch.profiler.ProfilerActivity.CUDA
                not in torch.profiler.supported_activities()):
            print("[mem] --profile: this PyTorch cannot trace the CUDA "
                  "device (no ProfilerActivity.CUDA); a trace of the CPU "
                  "alone would hide the device", file=sys.stderr)
            return 1

    timer = StageTimer()
    with timer.stage("index_load"):
        idx = load_index(args.prefix)
    if len(idx.text) >= 2**31:
        # the seeding takes wide coordinates; the extension, here as in the
        # JAX package (bwameme_tpu/align/extend.py _pack_jobs), packs text
        # offsets as int32
        print("[mem] texts of 2^31 bases or more: the extension packs text "
              "offsets as int32, as the JAX package does (ROADMAP Queue 3)",
              file=sys.stderr)
        return 1
    rg_id = rg_line = None
    if args.R:
        rg_line = args.R.replace("\\t", "\t")
        for f in rg_line.split("\t"):
            if f.startswith("ID:"):
                rg_id = f[3:]
    pes0 = None
    if args.insert_spec:
        pes0 = insert_size(args.insert_spec)
        fr = pes0[1]
        print(f"[mem] fixed FR insert size: avg={fr.avg} std={fr.std} "
              f"range [{fr.low},{fr.high}]", file=sys.stderr)
    engine = aligner = None
    if args.backend == "fmi":
        try:
            engine = fmi_engine(args, idx, opt, device, timer)
        except ValueError as e:     # an FM-index text past 2^31 bases
            print(f"[mem] {e}", file=sys.stderr)
            return 1
    elif args.engine == "device":
        from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine

        kw = dict(mode=args.mode)
        if args.backend == "ert":
            kw.update(root="kmer", ert_bits=ert_bits(args.prefix, idx))

        # each dp row sees 1/dp of every batch
        lanes = -(-args.batch // len(mesh)) if mesh else args.batch

        def make_engine(row):
            return DeviceSeedingEngine(idx, opt, lanes=lanes, device=row[0],
                                       shards=row if len(row) > 1 else None,
                                       **kw)

        with timer.stage("index_upload"):
            try:
                if mesh is None or len(mesh) == 1:
                    engine = make_engine(mesh[0] if mesh else [device])
                else:
                    from bwameme_tpu_torch.parallel.dp import \
                        DataParallelAligner

                    aligner = DataParallelAligner(
                        idx, opt, mesh=mesh, engine_factory=make_engine,
                        rg_id=rg_id, copy_comment=args.copy_comment,
                        pes0=pes0)
            except (ValueError, RuntimeError) as e:
                # a layout the index cannot have (modes 3 and 4 of a
                # --no-isa index) or that does not fit the device
                print(f"[mem] {e}", file=sys.stderr)
                return 1
    if aligner is None:
        aligner = Aligner(idx, opt, seeding_engine=engine, rg_id=rg_id,
                          copy_comment=args.copy_comment, device=device,
                          pes0=pes0)
    extra_hdr = None
    if args.hdr_insert:
        hdr_lines = []
        for h in args.hdr_insert:
            if h.startswith("@"):
                hdr_lines.append(h.replace("\\t", "\t"))
            else:
                with open(h) as f:
                    hdr_lines.extend(ln.rstrip("\n") for ln in f)
        extra_hdr = "\n".join(hdr_lines)
    if args.ignore_alt:
        for c in idx.bns.contigs:
            c.is_alt = False

    out = open(args.outfile, "w") if args.outfile else sys.stdout
    prof = None
    try:
        pg = sam.make_pg_line(__version__, " ".join(sys.argv))
        out.write(sam.sam_header(idx.bns, rg_line=rg_line, pg_line=pg,
                                 extra_hdr=extra_hdr))
        chunk_bp = args.K if args.K else 10_000_000 * max(args.t, 1)
        paired = args.reads2 is not None or args.smartpe
        n = 0
        if args.profile_dir:
            prof = start_trace(args.profile_dir, cuda=on_card)
        t0 = time.time()
        for chunk in fastq.read_chunks(
                args.reads1, args.reads2, chunk_bp,
                keep_pairs=paired and args.reads2 is None):
            with timer.stage("align"):
                if paired:
                    blocks = [aligner.align_pairs(chunk)]
                else:
                    batches = (chunk[i: i + args.batch]
                               for i in range(0, len(chunk), args.batch))
                    blocks = aligner.align_stream(batches)
                for block in blocks:
                    with timer.stage("write"):
                        out.writelines(block)
            n += len(chunk)
            print(f"[mem] processed {n} reads "
                  f"({n / (time.time() - t0):.0f} reads/s, {device})",
                  file=sys.stderr)
        timer.report(sys.stderr)
        if args.verbose >= 3:
            TPROF.report(sys.stderr, total=time.time() - t0,
                         label="pipeline sub-stages (of wall)")
    finally:
        if prof is not None:
            stop_trace(prof)
            print(f"[mem] torch profiler trace -> {args.profile_dir}",
                  file=sys.stderr)
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_version() -> int:
    import torch

    print(__version__)
    cuda = (f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} "
            "device(s)" if torch.cuda.is_available() else "no CUDA device")
    print(f"* Backend: PyTorch {torch.__version__} ({cuda})", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "index":
        return cmd_index(args)
    if args.cmd == "version":
        return cmd_version()
    return cmd_mem(args)


if __name__ == "__main__":
    sys.exit(main())
