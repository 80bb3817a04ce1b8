"""The port's integer LSTM (PORT profile) against cmix_tpu.mixer.ilstm:
the same initial weights, and one shared byte update from identical
state, exact, with plain SGD and with the integer Adam (ILSTM_ADAM), at
the BPTT windows W the CLI picks (4 up to 256 KiB of input, else 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu.mixer import ilstm as jil
from cmix_tpu_torch.mixer import ilstm as til

CPU = torch.device("cpu")
B, H = 4, 32
WINDOWS = [4, 8]


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("adam", [False, True])
def test_init_is_identical(adam, W):
    sh_j = _np(jil.init_ilstm_shared(jil.ILstmConfig(hidden=H, horizon=W,
                                                     adam=adam)))
    sh_t = til.init_ilstm_shared(til.ILstmConfig(hidden=H, horizon=W,
                                                 adam=adam), CPU)
    assert set(sh_t) == set(sh_j)
    for k in sh_j:
        assert sh_t[k].dtype == torch.int32
        assert np.array_equal(sh_t[k].numpy(), sh_j[k]), k
    pb_j = _np(jil.init_ilstm_perblock(jil.ILstmConfig(hidden=H, horizon=W)))
    pb_t = til.init_ilstm_perblock(til.ILstmConfig(hidden=H, horizon=W), B,
                                   CPU)
    for k, v in pb_j.items():
        assert np.array_equal(pb_t[k].numpy(),
                              np.tile(v[None], (B,) + (1,) * v.ndim))


def test_hidden_above_256_is_refused():
    with pytest.raises(ValueError, match="256"):
        til.ILstmConfig(hidden=512)


@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("adam", [False, True])
def test_one_update_from_identical_state(adam, W):
    kw = dict(hidden=H, horizon=W, adam=adam, lr_wx=192 * 3, lr_wh=96 * 3,
              lr_wo=96 * 3, lr_b=48 * 3, alr_wx=40 * 3, alr_wh=20 * 3,
              alr_wo=20 * 3, alr_b=10 * 3)
    cj, ct = jil.ILstmConfig(**kw), til.ILstmConfig(**kw)
    data = np.frombuffer(open("testdata/text100k.raw", "rb").read()[
        :B * 64], np.uint8).reshape(B, 64).astype(np.int32)
    sh = jil.init_ilstm_shared(cj)
    pb = jax.tree_util.tree_map(lambda x: jnp.tile(x[None], (B,) + (1,) *
                                                   x.ndim),
                                jil.init_ilstm_perblock(cj))
    step = jax.jit(lambda s, p, b: jil.ilstm_shared_byte_update(cj, s, p, b))
    for t in range(40):                      # a grown, non-trivial state
        sh, pb = step(sh, pb, jnp.asarray(data[:, t]))
    sh_t, pb_t = _t(_np(sh)), _t(_np(pb))
    sh, pb = step(sh, pb, jnp.asarray(data[:, 40]))
    sh_t, pb_t = til.ilstm_shared_byte_update(
        ct, sh_t, pb_t, torch.as_tensor(data[:, 40].astype(np.int64)))
    for ref, got in ((sh, sh_t), (pb, pb_t)):
        assert set(got) == set(ref)
        for k, r in _np(ref).items():
            assert got[k].dtype == torch.int32, k
            assert np.array_equal(got[k].numpy(), r), k
    # the update really moved the weights and the distribution
    assert int(np.abs(np.asarray(sh["wo"]) - _np(jil.init_ilstm_shared(cj))[
        "wo"]).max()) > 0


@pytest.mark.parametrize("adam", [False, True])
def test_cpu_tensors_take_the_plain_path(adam):
    """The wrapper on CPU tensors runs the plain version (every leaf equal
    to ``_update_plain``'s) and counts no kernel launch."""
    ct = til.ILstmConfig(hidden=H, horizon=4, adam=adam)
    sh, pb = til.init_ilstm_shared(ct, CPU), til.init_ilstm_perblock(ct, B,
                                                                    CPU)
    data = np.frombuffer(open("testdata/text100k.raw", "rb").read()[
        :B * 8], np.uint8).reshape(8, B).astype(np.int64)
    n0 = til.ilstm_shared_byte_update.launches
    want = sh, pb
    for t in range(8):
        byte = torch.as_tensor(data[t])
        sh, pb = til.ilstm_shared_byte_update(ct, sh, pb, byte)
        want = til._update_plain(ct, *want, byte)
    assert til.ilstm_shared_byte_update.launches == n0
    for got, ref in zip((sh, pb), want):
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k


def test_lane_group_follows_the_sms(monkeypatch):
    """One lane a block of the lane kernels while the lanes fit on the
    SMs, two above (the note in csrc/ilstm_update.cu)."""
    dev = torch.device("cuda", 0)
    monkeypatch.setitem(til._SMS, dev, 132)
    assert [til._lanes(b, dev) for b in (1, 64, 132, 133, 256)] == [
        1, 1, 1, 2, 2]
