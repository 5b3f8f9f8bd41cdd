"""The golden paired-end configs (tests/test_golden_sam.py's pe_Y and
pe_default, which bwameme_tpu reproduces byte for byte) through
``bwameme_tpu_torch.cli mem`` on the CPU: with --engine host (the serial
per-pair rescue), with the default device engine (the plain versions, the
chunk's rescue in one call of the full SW's coordinate form, the C++ pair
finalization) in batches that split the 200 pairs, and with the device
engine on one interleaved file (-p)."""

import gzip
import os

import pytest
import torch

from bwameme_tpu_torch import cli
from bwameme_tpu_torch.ops import launch

GOLD = os.path.join(os.path.dirname(__file__), "golden")
PE_CONFIGS = [("pe_Y", ["-Y"]), ("pe_default", [])]
RUNS = {
    "host": (["--engine", "host"], False),
    "device": (["--batch", "96"], False),
    "device_interleaved": (["--batch", "96", "-p"], True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on small tensors: one intra-op thread is as
    fast, and does not oversubscribe cores that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    """The golden reference indexed by the port's CLI, both mates' files,
    and the pairs interleaved in one file."""
    d = tmp_path_factory.mktemp("golden_pe_torch")
    for name in ["ref.fa", "reads_1.fq", "reads_2.fq"]:
        with gzip.open(os.path.join(GOLD, name + ".gz"), "rt") as f:
            (d / name).write_text(f.read())
    r1 = (d / "reads_1.fq").read_text().splitlines(keepends=True)
    r2 = (d / "reads_2.fq").read_text().splitlines(keepends=True)
    assert len(r1) == len(r2) == 4 * 200
    (d / "reads_12.fq").write_text("".join(
        "".join(r1[i: i + 4] + r2[i: i + 4]) for i in range(0, len(r1), 4)))
    assert cli.main(["index", str(d / "ref.fa"), "-p", str(d / "idx")]) == 0
    return d


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("name,flags", PE_CONFIGS,
                         ids=[c[0] for c in PE_CONFIGS])
def test_golden_pe_through_port_cli(golden_dir, tmp_path, monkeypatch, name,
                                    flags, run):
    monkeypatch.setenv("BWAMEME_PLATFORM", "cpu")
    extra, interleaved = RUNS[run]
    reads = ([str(golden_dir / "reads_12.fq")] if interleaved else
             [str(golden_dir / "reads_1.fq"), str(golden_dir / "reads_2.fq")])
    out = tmp_path / f"{name}.sam"
    rc = cli.main(["mem", "-K", "100000000", *flags, str(golden_dir / "idx"),
                   *reads, *extra, "-o", str(out)])
    assert rc == 0
    got = [ln for ln in out.read_text().splitlines() if not ln.startswith("@")]
    with gzip.open(os.path.join(GOLD, name + ".sam.gz"), "rt") as f:
        assert got == f.read().splitlines()
    # on the CPU the plain versions ran: no kernel launch
    assert sum(launch.stats.launches.values()) == 0
