"""bwameme_tpu_torch imports neither JAX nor any module of bwameme_tpu,
directly or through what it imports.

Checked in a subprocess, because this suite's conftest imports jax: an
import hook there refuses every jax module and the top-level package
``bwameme_tpu``, then every module of the port (and chip_smoke.py) is
imported, a toy index is built with the port's own index/build.py and a few
reads and a pair whose second mate only a rescue places are aligned on the
CPU with every seeding engine (host, learned, ERT, both FM-index engines;
so the pairing, finalize and alt copies and the full SW run too); the host libraries it loaded are the port's own, none
from native/build/, which bwameme_tpu's loaders write. A source check
backs the hook: no file of the port, nor chip_smoke.py, has an import
statement that names bwameme_tpu.
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "bwameme_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Blocked())

import numpy as np
import bwameme_tpu_torch
import chip_smoke  # noqa: F401

names = [m.name for m in pkgutil.walk_packages(bwameme_tpu_torch.__path__,
                                                "bwameme_tpu_torch.")]
for name in names:
    importlib.import_module(name)

from bwameme_tpu_torch.cli import insert_size
from bwameme_tpu_torch.index import bntseq
from bwameme_tpu_torch.index.build import build_index
from bwameme_tpu_torch.io.fastq import Read
from bwameme_tpu_torch.pipeline import Aligner
from bwameme_tpu_torch.seeding.engine import DeviceSeedingEngine
from bwameme_tpu_torch.seeding.fmi_engine import FmiDeviceEngine, FmiHostEngine
from bwameme_tpu_torch.utils.config import MEM_F_PE, MemOptions

rng = np.random.default_rng(5)
code = rng.integers(0, 4, 20000).astype(np.uint8)
bns = bntseq.BntSeq(l_pac=len(code),
                    contigs=[bntseq.Contig("chrT", "", 0, len(code), 0)],
                    ambs=[], code=code)
idx = build_index(bns, rmi_bits=10)
reads = [Read(f"r{i}", "".join("ACGT"[c] for c in idx.text[s: s + 151]),
              "I" * 151, None)
         for i, s in enumerate((100, 5000, 12000, 30000))]
opt = MemOptions()
engines = {"host": None,
           "device": DeviceSeedingEngine(idx, opt, device="cpu"),
           "ert": DeviceSeedingEngine(idx, opt, device="cpu", root="kmer"),
           "fmi": FmiDeviceEngine(idx, opt, device="cpu"),
           "fmi_host": FmiHostEngine(idx, opt)}
for name, engine in engines.items():
    sam = Aligner(idx, opt, seeding_engine=engine,
                  device="cpu").align_batch(reads)
    # the last read lies on the reverse-complement half: forward position
    # 2*l_pac - (30000 + 151), on the reverse strand
    got = [ln.split("\t")[1:4] for ln in sam]
    assert got == [["0", "chrT", "101"], ["0", "chrT", "5001"],
                   ["0", "chrT", "12001"], ["16", "chrT", "9850"]], (name, got)
    # a pair: the second mate (reverse strand, 400 bases on) mutated every
    # 12th base, so that only the mate rescue places it
    mate = (3 - idx.text[3249: 3400][::-1]).astype(np.uint8)
    mate[6::12] = (mate[6::12] + 1) % 4
    pair = [Read("p", "".join("ACGT"[c] for c in idx.text[3000: 3151]),
                 "I" * 151, None),
            Read("p", "".join("ACGT"[c] for c in mate), "I" * 151, None)]
    popt = MemOptions()
    popt.flag |= MEM_F_PE
    sam = Aligner(idx, popt, seeding_engine=engine, device="cpu",
                  pes0=insert_size("400,40")).align_pairs(pair)
    got = [ln.split("\t")[1:4] for ln in sam]
    assert got == [["99", "chrT", "3001"], ["147", "chrT", "3251"]], (name,
                                                                      got)
maps = open("/proc/self/maps").read()
assert "/native/build/" not in maps
assert "/bwameme_tpu_torch/build/libhostkernels.so" in maps
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "bwameme_tpu"))
assert not loaded, loaded
print("OK", len(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "BWAMEME_PLATFORM"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _dirs, files in os.walk(os.path.join(REPO, "bwameme_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_sources_name_no_module_of_the_jax_package():
    """``import bwameme_tpu`` / ``from bwameme_tpu`` followed by a dot or a
    space, or ``import jax``, anywhere in the port's sources (comments that
    cite the counterpart by path do not match)."""
    pat = re.compile(r"^\s*(import|from)\s+(bwameme_tpu|jax|jaxlib)[.\s]",
                     re.M)
    files = list(_port_sources())
    assert len(files) > 30
    bad = [os.path.relpath(f, REPO) for f in files
           if pat.search(open(f).read() + "\n")]
    assert not bad, bad
