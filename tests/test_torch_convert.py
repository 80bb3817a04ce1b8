"""``convert.from_jax_state`` runs where every entry point of the port runs:
on the card by default, on the CPU only when asked."""

import numpy as np
import pytest
import torch

from cmix_tpu_torch import convert, engine

PB = {"dmc_cur": np.arange(3, dtype=np.int32),
      "dmc_nxt": np.arange(12, dtype=np.uint32).reshape(3, 4)}


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert convert.from_jax_state({}, PB, {})[1]["dmc_cur"].is_cuda
        return
    with pytest.raises(RuntimeError) as want:
        engine.resolve_device("cuda")
    with pytest.raises(RuntimeError) as got:
        convert.from_jax_state({}, PB, {})
    assert str(got.value) == str(want.value)


def test_cpu_when_asked():
    _, pb, _ = convert.from_jax_state({}, PB, {}, device="cpu")
    assert pb["dmc_cur"].device.type == "cpu"
    assert pb["dmc_cur"].tolist() == [0, 1, 2]
    assert pb["dmc_nxt"].dtype == torch.int32
    assert np.array_equal(convert.to_numpy({}, pb, {})[1]["dmc_nxt"],
                          PB["dmc_nxt"])


# the leaves the off-by-default mechanisms add or widen
GATED_LEAVES = ("jval", "jval2", "w_sse", "sbank_c", "vmatch_conf", "w1",
                "w1_cnt", "w2", "w2b", "w2c", "w2x", "apm", "w_apm")
_GATED_SETS = {
    "mixer": {"MIX_DYN4": 1, "MIX_KIND": 1, "MIX_AUX": 1, "MIX_TAU": 100.0,
              "MIX_BOOST": 2.0},
    "sse": {"APM3X": 1, "SSE2": 1, "SBANK_ADAPT": 1, "APM_FIXED": 1},
    "vmatch": {"VMATCH": 1},
    "jval2": {"JVAL": 2, "JPEGX": 1},
    "port_mixer": {"PORT": 1, "MIX_DYN4": 1, "MIX_KIND": 1, "MIX_AUX": 1},
    "port_sse": {"PORT": 1, "APM3X": 1, "SSE2": 1, "APM_FIXED": 1},
    "port_jval2": {"PORT": 1, "JVAL": 2, "JPEGX": 1}}


@pytest.mark.parametrize("name", sorted(_GATED_SETS))
def test_gated_leaves_round_trip(name):
    """At each gate set the JAX package's fresh state (its new leaves
    perturbed) goes to the port and back to numpy unchanged, and the port's
    own fresh state has the same keys, dtypes and values (the float LSTM's
    random initial weights aside: tests/test_torch_lstm.py holds those)."""
    from cmix_tpu import engine as je
    from torch_parity import _flat, jax_runner_gates
    env = _GATED_SETS[name]
    kw = dict(block_size=64, seg_size=64, tbits=10, mbits=10, ibits=8,
              pbits=10, lstm_hidden=8, lstm_horizon=2, dmc_nodes=4096)
    rng = np.random.default_rng(7)
    with jax_runner_gates(env):
        jcfg = je.EngineConfig(**kw)
        sh = {k: np.asarray(v) if not isinstance(v, dict) else v
              for k, v in je.init_shared(jcfg).items()}
        pb = je.init_perblock(jcfg)
    g = engine.make_gates(env)
    cpu = torch.device("cpu")
    fresh = convert.to_numpy(engine.init_shared(engine.EngineConfig(**kw), g,
                                                cpu), {}, {})[0]
    ref = _flat(sh)
    got = _flat(fresh)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        if k.startswith("lstm.params"):
            assert np.allclose(got[k], ref[k], rtol=0, atol=1e-6), k
        else:
            assert np.array_equal(got[k], ref[k]), k
    present = [k for k in GATED_LEAVES if k in sh]
    for k in present:
        a = sh[k]
        sh[k] = (rng.integers(0, 256, a.shape).astype(a.dtype)
                 if a.dtype.kind in "iu" else
                 rng.standard_normal(a.shape).astype(a.dtype))
    back = convert.to_numpy(*convert.from_jax_state(sh, pb, {},
                                                    device="cpu"))[0]
    for k in present:
        assert back[k].dtype == sh[k].dtype, k
        assert np.array_equal(back[k], sh[k]), k
    assert ("jval2" in present) == (name.endswith("jval2"))
    assert ("w_sse" in present) == (name.endswith("sse"))
