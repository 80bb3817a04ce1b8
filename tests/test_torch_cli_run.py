"""``python -m cmix_tpu_torch.tools.cli_run``, the CLI's whole run on one
file (``c`` then ``d`` through ``runner.main`` in one process), on a tiny
input on the CPU: one JSON line a direction, the header's widths and gate
record read back, an exact round trip, runner options passed on."""

import json

import torch_parity  # noqa: F401  (one torch thread per worker)
from cmix_tpu_torch.tools import cli_run

SMALL = ["--device", "cpu", "--block-size", "32", "--tbits", "10",
         "--lstm", "16", "--dmc", "4096", "--max-batch", "1", "--portable"]


def _lines(out):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_cli_run_codes_both_ways(tmp_path, capsys):
    src = tmp_path / "in.txt"
    with open("testdata/text100k.raw", "rb") as f:
        src.write_bytes(f.read()[:48])
    assert cli_run.main([str(src), str(tmp_path / "o")] + SMALL) == 0
    enc, dec = _lines(capsys.readouterr().out)
    arc = (tmp_path / "o" / "in.txt.tcmx").read_bytes()
    assert enc["mode"] == "compress" and dec["mode"] == "decompress"
    assert enc["archive_bytes"] == len(arc) and enc["bytes"] == 48
    assert enc["header"] == dict(
        block_size=32, tbits=10, mbits=20, ibits=16, pbits=20,
        dmc_nodes=4096, seg_size=32, lstm_layers=2, lstm_horizon=4,
        lstm_hidden=16, exec_batch=1, blocks=2, gates="PORT=1")
    # two coding groups of one lane, 32 steps each
    assert enc["ms_per_step"] == enc["s"] / 64 * 1e3
    assert enc["peak_device_bytes"] is None and dec["exact"] is True
    assert (tmp_path / "o" / "in.txt.back").read_bytes() == src.read_bytes()
