"""Command-line interface of the port: ``index`` and ``mem``.

``python -m bwameme_tpu_torch.cli index ref.fa`` builds the same learned
index as bwameme_tpu (it is the same host code). ``python -m
bwameme_tpu_torch.cli mem PREFIX reads.fq --engine host`` aligns single-end
reads: host seeding and chaining, extension in the CUDA kernel, native
finalization; it writes the same SAM header and records as bwameme_tpu.
The flags are bwameme_tpu's; what is not ported yet exits 1 naming its
ROADMAP item.

The device is CUDA unless BWAMEME_PLATFORM=cpu asks for the CPU (where the
kernels' plain PyTorch versions run). A missing CUDA device is an error,
never a silent move to the CPU.
"""

from __future__ import annotations

import os
import sys
import time

from bwameme_tpu.cli import build_parser, cmd_index
from bwameme_tpu_torch import __version__


def _not_ported(args) -> str | None:
    if args.reads2 is not None or args.smartpe:
        return ("paired-end alignment is not ported yet "
                "(ROADMAP Queue 1 item 9)")
    if args.engine != "host":
        return ("--engine device is not ported yet (ROADMAP Queue 1 items "
                "5-7); use --engine host")
    if args.ert or args.backend != "learned":
        return ("the ERT and FM-index backends are not ported yet (ROADMAP "
                "Queue 1 items 11-12)")
    if args.shards > 1 or args.dp_shards > 1:
        return "--shards/--dp-shards are not ported yet (ROADMAP Queue 1 item 14)"
    if args.profile_dir:
        return "--profile (a jax.profiler trace) has no counterpart in the port"
    return None


def mem_options(args):
    """MemOptions from the mem flags, exactly as bwameme_tpu.cli.cmd_mem
    assembles them; None for an unknown -x preset."""
    from bwameme_tpu.utils.config import (
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


def select_device():
    """CUDA, or the CPU when BWAMEME_PLATFORM=cpu; None if CUDA is asked
    for and absent."""
    import torch

    if os.environ.get("BWAMEME_PLATFORM") == "cpu":
        return torch.device("cpu")
    return torch.device("cuda") if torch.cuda.is_available() else None


def cmd_mem(args) -> int:
    from bwameme_tpu.index.build import load_index
    from bwameme_tpu.io import fastq, sam
    from bwameme_tpu.utils.timer import TPROF, StageTimer
    from bwameme_tpu_torch.pipeline import Aligner

    msg = _not_ported(args)
    if msg:
        print(f"[mem] {msg}", file=sys.stderr)
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

    timer = StageTimer()
    with timer.stage("index_load"):
        idx = load_index(args.prefix)
    if len(idx.text) >= 2**31:
        print("[mem] texts of 2^31 bases or more need int64 device "
              "coordinates, not ported yet (ROADMAP Queue 1 item 10)",
              file=sys.stderr)
        return 1
    rg_id = rg_line = None
    if args.R:
        rg_line = args.R.replace("\\t", "\t")
        for f in rg_line.split("\t"):
            if f.startswith("ID:"):
                rg_id = f[3:]
    aligner = Aligner(idx, opt, rg_id=rg_id, copy_comment=args.copy_comment,
                      device=device)
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
    try:
        pg = sam.make_pg_line(__version__, " ".join(sys.argv))
        out.write(sam.sam_header(idx.bns, rg_line=rg_line, pg_line=pg,
                                 extra_hdr=extra_hdr))
        chunk_bp = args.K if args.K else 10_000_000 * max(args.t, 1)
        n = 0
        t0 = time.time()
        for chunk in fastq.read_chunks(args.reads1, None, chunk_bp,
                                       keep_pairs=False):
            with timer.stage("align"):
                batches = (chunk[i: i + args.batch]
                           for i in range(0, len(chunk), args.batch))
                for blocks in aligner.align_stream(batches):
                    with timer.stage("write"):
                        out.writelines(blocks)
            n += len(chunk)
            print(f"[mem] processed {n} reads "
                  f"({n / (time.time() - t0):.0f} reads/s, {device})",
                  file=sys.stderr)
    finally:
        if out is not sys.stdout:
            out.close()
    timer.report(sys.stderr)
    if args.verbose >= 3:
        TPROF.report(sys.stderr, total=time.time() - t0,
                     label="pipeline sub-stages (of wall)")
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
