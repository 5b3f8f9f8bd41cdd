"""The port's DeviceIndex against the JAX package's, byte for byte: the state
that carries across (the planes of every mode and width, packed text with
guard words, fused P-RMI leaf records, wide leaf starts). Tolerance zero:
every plane is integer words."""

import numpy as np
import pytest
import torch

from bwameme_tpu.index import bntseq
from bwameme_tpu.index.build import build_index
from bwameme_tpu.ops.sa_search import DeviceIndex as JaxDeviceIndex
from bwameme_tpu_torch.index import device as dev_mod
from bwameme_tpu_torch.index.device import DeviceIndex, DeviceText


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(31)
    n = 24000
    code = rng.integers(0, 4, n).astype(np.uint8)
    code[8000:8400] = np.tile(code[8000:8050], 8)
    bns = bntseq.BntSeq(l_pac=n, contigs=[bntseq.Contig("c", "", 0, n, 0)],
                        ambs=[], code=code)
    idx = build_index(bns, rmi_bits=10)
    jd = JaxDeviceIndex.from_host(idx, mode=4)
    return idx, jd, DeviceIndex.from_host(idx, "cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("plane", ["rk", "text32", "params"])
def test_from_host_planes_equal_jax(planes, plane):
    _idx, jd, di = planes
    want = np.asarray(getattr(jd, plane))
    got = _u32(getattr(di, plane))
    assert want.dtype == np.uint32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_scalars_and_guard_words(planes):
    idx, jd, di = planes
    assert (di.bits, di.n_sa) == (jd.bits, jd.n_sa)
    assert di.rk.dtype == di.text32.dtype == di.params.dtype == torch.int32
    # the packed text ends in all-T guard words
    assert (_u32(di.text32)[-12:] == 0xFFFFFFFF).all()
    assert di.max_width == int((idx.rmi_err_lo.astype(np.int64)
                                + idx.rmi_err_hi.astype(np.int64)).max())


def test_from_numpy_round_trip(planes):
    _idx, jd, di = planes
    back = DeviceIndex.from_numpy(np.asarray(jd.text32),
                                  np.asarray(jd.params), jd.bits, jd.n_sa,
                                  "cpu", rk=np.asarray(jd.rk))
    for plane in ("rk", "text32", "params"):
        assert torch.equal(getattr(back, plane), getattr(di, plane))
    assert (back.bits, back.n_sa) == (di.bits, di.n_sa)


def test_numpy_rows_equal_native_rows(planes, monkeypatch):
    """The numpy assembly of the rank rows (used without the native host
    library) equals the native one."""
    from bwameme_tpu_torch.align import native

    idx, _jd, di = planes
    monkeypatch.setattr(native, "build_mode4_rows_native",
                        lambda *a, **k: None)
    assert dev_mod.mode4_rows(idx).tobytes() == _u32(di.rk).tobytes()


def test_device_text_is_the_same_words(planes):
    idx, _jd, di = planes
    assert torch.equal(DeviceText.from_host(idx, "cpu").text32, di.text32)


@pytest.mark.parametrize("mode,wide", [(1, False), (1, True), (3, False),
                                       (4, True)],
                         ids=["mode1", "mode1_wide", "mode3", "mode4_wide"])
def test_planes_of_each_layout_equal_jax(planes, mode, wide):
    """The planes of a layout, from the host index and carried across from
    the JAX package's DeviceIndex of the same layout (tests/test_torch_modes.py
    holds every layout's search against the JAX package's)."""
    idx = planes[0]
    jd = JaxDeviceIndex.from_host(idx, mode=mode, wide=wide)
    di = DeviceIndex.from_host(idx, "cpu", mode=mode, wide=wide)
    assert (di.mode, di.wide) == (mode, wide)
    names = [k for k in ("rk", "sa", "ktext", "key2", "params64")
             if getattr(jd, k) is not None]
    assert sorted(names) == sorted(k for k in di.planes
                                   if k not in ("text32", "params"))
    for name in names + ["text32", "params"]:
        want, got = np.asarray(getattr(jd, name)), getattr(di, name).numpy()
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    back = DeviceIndex.from_numpy(
        np.asarray(jd.text32), np.asarray(jd.params), jd.bits, jd.n_sa,
        "cpu", **{k: np.asarray(getattr(jd, k)) for k in names})
    for name, t in di.planes.items():
        assert torch.equal(getattr(back, name), t)


def test_the_kmer_root_is_not_ported(planes):
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        DeviceIndex.from_host(planes[0], "cpu", ert_bits=0)
