"""A run whose timed path is broken underneath comes out not correct.

The harness's run is driven on the CPU at a tiny size (its look for a
card skipped), with one fault planted in the program each time:

* the byte step returns its state unchanged (the model never learns);
* half of the batch left out: the second half of the lanes gets the
  first half's streams;
* a token altered where it is produced: one byte of a lane's stream
  flipped as the transcoder hands it back.

One cell runs on one chip, so there is no exchange between chips to
leave out.  A run with nothing planted is correct.
"""

import time

import pytest
import torch

from portbench.harness import cell as C

from tiny import tiny_cell


def _run(monkeypatch, fault):
    from cmix_tpu_torch import engine, runner
    from cmix_tpu_torch.utils.checkpoint import clone_state
    if fault == "state_unchanged":
        make = engine.make_byte_step

        def make_step(*a, **k):
            step = make(*a, **k)

            def frozen(sh, pb, cd, comp, inp, t, mode):
                # the step writes some tables in place: keep copies
                sh0, pb0 = clone_state(sh), clone_state(pb)
                _, _, cd2, e32, c32 = step(sh, pb, cd, comp, inp, t, mode)
                return sh0, pb0, cd2, e32, c32
            return frozen
        monkeypatch.setattr(engine, "make_byte_step", make_step)
    elif fault in ("half_batch", "token_altered"):
        make = runner.make_transcoder

        def make_trans(*a, **k):
            trans = make(*a, **k)

            def broken(sh, pb, inp, comp, mode, **kw):
                hist, out, out_len = trans(sh, pb, inp, comp, mode, **kw)
                if fault == "half_batch":
                    h = out.shape[0] // 2
                    out[h:], out_len[h:] = out[:h], out_len[:h]
                else:
                    out[0, 2] ^= 0x40
                return hist, out, out_len
            broken.state = trans.state
            return broken
        monkeypatch.setattr(runner, "make_transcoder", make_trans)
    result, lines = C.run(tiny_cell(), 2**31 + 77, 0.0, False,
                          torch.device("cpu"), time.perf_counter())
    return result


def test_a_sound_run_is_correct(monkeypatch):
    r = _run(monkeypatch, None)
    assert r["correct"] and r["failed"] == 0
    assert list(r["checks"]) == ["roundtrip_bad_bytes", "archive_bad_bytes"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    r = _run(monkeypatch, fault)
    assert not r["correct"]
    assert r["checks"]["archive_bad_bytes"]["value"] > 0
