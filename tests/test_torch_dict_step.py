"""One byte step of the port's engine vs the JAX package's, from identical
state, on WRT-coded text (english.dic) with the codeword tracker on:
WRTW=1 on the defaults, WRTW=2 with the dictionary's codeword tables in
the shared state, WRTW=1 on the bench speed profile and on the portable
profile (PORT=1, every leaf exact).  In each lane the compared byte
completes a codeword.  The comparison and its tolerances are
``torch_parity.step_parity``'s."""

import numpy as np
import pytest

import cmix_tpu.contexts.hashes as jh
from cmix_tpu_torch import engine as E
from cmix_tpu_torch.preprocess import wrt
from torch_parity import jax_gates, step_parity  # noqa: F401

WARM = 40
DIC = "cmix_tpu_torch/data/english.dic"
CASES = {
    "wrtw1": {"WRTW": 1},
    "wrtw2_tables": {"WRTW": 2},
    "bench_wrtw1": dict(E.BENCH_GATES, WRTW=1),
    "port_wrtw1": {"PORT": 1, "WRTW": 1},
}


def _lanes():
    """(4, WARM + 1) lanes of WRT-coded text100k.raw whose last byte
    completes a codeword from an idle tracker: two 1-byte codewords, then
    two 2-byte ones."""
    with open("testdata/text100k.raw", "rb") as f:
        enc = wrt.Dictionary(DIC).encode(f.read()[:20000])
    e = np.frombuffer(enc, np.uint8).astype(np.int64)
    plain = lambda x: (x < 0x80) & (x != 0x04)              # noqa: E731
    ends = np.arange(8, len(e))
    one = ends[(e[ends] >= 0x80) & (e[ends] < 0xC0) & plain(e[ends - 1])
               & plain(e[ends - 2]) & (e[ends - 3] < 0xF0)]
    two = ends[(e[ends - 1] >= 0xC0) & (e[ends - 1] < 0xF0)
               & plain(e[ends - 2]) & plain(e[ends - 3])
               & (e[ends - 4] < 0xF0)]
    picks = [p for p in (one[one > WARM][:2].tolist()
                         + two[two > WARM][:2].tolist())]
    return np.stack([e[p - WARM:p + 1] for p in picks]).astype(np.uint8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dict_byte_step_matches_jax(case, jax_gates):
    env = CASES[case]
    jax_gates(env)
    prev = jh.WRTW_TABLES
    if env["WRTW"] >= 2:
        # the tables init_shared copies into the shared state (as the JAX
        # runner registers them for the archive's dictionary)
        jh.WRTW_TABLES = jh.build_wrtw_tables(
            [w.lower() for w in wrt.Dictionary(DIC).words])
    try:
        g = step_parity(env, _lanes(), warm=WARM)
    finally:
        jh.WRTW_TABLES = prev
    assert g.wrtw == env["WRTW"]
