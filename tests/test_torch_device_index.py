"""The port's DeviceIndex against the JAX package's, byte for byte: the state
that carries across (mode-4 rank rows, packed text with guard words, fused
P-RMI leaf records). Tolerance zero: every plane is integer words."""

import types

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
    back = DeviceIndex.from_numpy(np.asarray(jd.rk), np.asarray(jd.text32),
                                  np.asarray(jd.params), jd.bits, jd.n_sa,
                                  "cpu")
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


@pytest.mark.parametrize("kw,exc,msg", [
    (dict(mode=1), NotImplementedError, "Queue 1 item 10"),
    (dict(mode=3), NotImplementedError, "Queue 1 item 10"),
    (dict(n_sa=2**31), ValueError, "Queue 1 item 10"),
    (dict(isa=None), ValueError, "inverse suffix array"),
], ids=["mode1", "mode3", "wide", "no_isa"])
def test_what_is_not_ported_raises(planes, kw, exc, msg):
    idx = planes[0]
    mode = kw.pop("mode", None)
    fake = types.SimpleNamespace(n_sa=idx.n_sa, isa=idx.isa)
    for k, v in kw.items():
        setattr(fake, k, v)
    with pytest.raises(exc, match=msg):
        DeviceIndex.from_host(fake, "cpu", mode=mode)
