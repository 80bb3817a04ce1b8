"""``utils/checkpoint.py``: a state saved and loaded leaf by leaf, a file
that does not fit the state refused, the pretraining cache key's parts,
and the cache itself (a hit loads, a changed gate set or device type
misses) with the replay stubbed out."""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu_torch import engine as E
from cmix_tpu_torch.utils import checkpoint

CFG = E.EngineConfig(block_size=16, seg_size=16, tbits=10, mbits=10, ibits=8,
                     pbits=10, lstm_hidden=8, lstm_horizon=2, dmc_nodes=4096)
CPU = torch.device("cpu")


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same(a[k], b[k])
        elif torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("env", [{}, {"PORT": 1}, {"WRTW": 2}])
def test_save_load_round_trip(env, tmp_path):
    g = E.make_gates(env)
    sh = E.init_shared(CFG, g, CPU)
    sh["w3"] = sh["w3"] + 1                  # not the initial values
    if "opt" in sh["lstm"]:                  # the float LSTM's Adam step
        sh["lstm"]["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, sh)
    back = checkpoint.load_state(path, E.init_shared(CFG, g, CPU))
    _same(back, sh)
    with np.load(path, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(n for n, _ in checkpoint._leaves(sh))
    assert ("wrtw_word" in sh) == (g.wrtw >= 2)


def test_a_file_that_does_not_fit_raises(tmp_path):
    g = E.make_gates({})
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, E.init_shared(CFG, g, CPU))
    wider = E.EngineConfig(**dict(vars(CFG), tbits=11))
    with pytest.raises(ValueError, match="bank"):
        checkpoint.load_state(path, E.init_shared(wider, g, CPU))
    with pytest.raises(ValueError, match="differ"):
        checkpoint.load_state(path, E.init_shared(CFG, E.make_gates(
            {"PORT": 1}), CPU))


def test_cache_key_parts():
    g, p = E.make_gates({"WRTW": 1}), E.make_gates({"WRTW": 1, "PORT": 1})
    like = E.init_shared(CFG, g, CPU)
    key = lambda **kw: checkpoint.pretrain_cache_key(**{  # noqa: E731
        "cfg": CFG, "g": g, "device": "cpu", "dict_bytes": b"ab",
        "like": like, **kw})
    assert key() == key()
    # the caller's segment does not split the cache: the pretrainer has
    # its own
    assert key(cfg=E.EngineConfig(**dict(vars(CFG), seg_size=8))) == key()
    others = [key(g=p, like=E.init_shared(CFG, p, CPU)),
              key(g=E.make_gates({})), key(device="cuda"),
              key(dict_bytes=b"ac"),
              key(cfg=E.EngineConfig(**dict(vars(CFG), mbits=11))),
              key(wrtw_tables=(np.ones(4, np.uint32),) * 2)]
    assert len({key(), *others}) == 1 + len(others)


def test_cache_hit_and_misses(tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoint, "CACHE_DIR", str(tmp_path))
    runs = []

    def fake_pretrainer(cfg, g, device):
        def pretrain(sh, data):
            runs.append(g.blob())
            sh["w3"] += float(len(data))
            return sh
        return pretrain
    monkeypatch.setattr(E, "make_pretrainer", fake_pretrainer)
    g = E.make_gates({"WRTW": 1})
    first = checkpoint.cached_pretrained_state(CFG, g, CPU, b"x y")
    again = checkpoint.cached_pretrained_state(CFG, g, CPU, b"x y")
    assert runs == [b"WRTW=1"]
    _same(again, first)
    assert float(first["w3"][0, 0]) == 1.0 / g.n_l2 + 3.0
    # a copy for a coding group leaves the base as it is
    copy = checkpoint.clone_state(first)
    copy["w3"] += 1.0
    copy["lstm"]["params"]["wx"][0, 0] = 5.0
    assert float(first["w3"][0, 0]) == 1.0 / g.n_l2 + 3.0
    assert float(first["lstm"]["params"]["wx"][0, 0]) != 5.0
    checkpoint.cached_pretrained_state(CFG, E.make_gates(E.BENCH_GATES), CPU,
                                       b"x y")
    assert runs == [b"WRTW=1", E.make_gates(E.BENCH_GATES).blob()]
    assert len(list(tmp_path.iterdir())) == 2
