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
