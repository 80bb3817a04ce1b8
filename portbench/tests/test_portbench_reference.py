"""The reference (a frozen copy of the program with a plain DMC) against
the program at a tiny size, and the
control, the reference one precision step lower, against the reference.
On the CPU: both profiles' archives equal the program's, and PORT=1's
control (float32 contractions) writes another archive.  On the card
(``cuda``): the same through the program's graph, and the fast
profile's control (TF32) writes another archive."""

import pytest
import torch

from portbench.harness import check
from portbench.harness.spec import engine_kwargs
from portbench.harness.traffic import Jobs
from portbench.reference import runner as R
from portbench.reference.engine import EngineConfig as RC
from portbench.reference.lower import lower_precision

from tiny import tiny_cell


def _archives(name, device, seed=2**31 + 5):
    from cmix_tpu_torch import runner as P
    from cmix_tpu_torch.engine import EngineConfig as PC
    cell = tiny_cell(name)
    kw = engine_kwargs(cell.config)
    gates, mb = dict(cell.config["gates"]), cell.config["max_batch"]
    data = Jobs(cell.traffic, seed, cell.bench_dir).job(2)
    prog = P.compress(data, PC(**kw), max_batch=mb, gates=gates,
                      device=device)
    ref = R.compress(data, RC(**kw), max_batch=mb, gates=gates,
                     device=device)
    with lower_precision("PORT" in gates):
        ctl = R.compress(data, RC(**kw), max_batch=mb, gates=gates,
                         device=device)
    return data, prog, ref, ctl


@pytest.mark.parametrize("name", ["cli.mixed.b64", "cli-portable.mixed.b64"])
def test_reference_writes_the_programs_archive(name):
    data, prog, ref, ctl = _archives(name, "cpu")
    assert check.diff_bytes(prog, ref) == 0
    assert R.decompress(ref, device="cpu") == data
    if "portable" in name:
        assert check.diff_bytes(ctl, ref) > 0


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cli.mixed.b64", "cli-portable.mixed.b64"])
def test_reference_and_control_on_the_card(name):
    _need_card()
    data, prog, ref, ctl = _archives(name, "cuda")
    assert check.diff_bytes(prog, ref) == 0
    assert check.diff_bytes(ctl, ref) > 0
