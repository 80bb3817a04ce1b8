"""The CLI's whole run on one file: ``c`` then ``d`` through
``runner.main`` in one process, each direction measured.

    python -m cmix_tpu_torch.tools.cli_run INPUT DIR [runner options]

Compresses INPUT to ``DIR/<name>.tcmx`` and decompresses that to
``DIR/<name>.back``, both with ``--stats`` (the Meter's JSON report and the
progress ticker go to stderr), at the CLI's defaults unless runner options
are given (``--portable``, ``--max-batch``, ``--device cpu``, ...).  For
each direction it prints one JSON line on stdout: seconds, ms a step
(seconds / the steps: the block size times the coding groups), ``dmc_fused``
launches and peak device memory (``torch.cuda.max_memory_allocated`` after
a reset; null on the CPU); the compress line adds the archive's bytes,
bpb, sha256, the header's widths and the gate record, the decompress line
whether the decoded bytes are INPUT.  Then the card's name and power limit
(on the card).  Exits 1 when the round trip is not exact.
"""

import hashlib
import json
import os
import struct
import sys
import time

import torch

from cmix_tpu_torch import runner
from cmix_tpu_torch.bench import card
from cmix_tpu_torch.models import dmc


def header(arc):
    """The widths the archive's header carries, and its gate record."""
    f = struct.unpack(runner._HDR, arc[4:4 + runner._HDR_LEN])
    off = 4 + runner._HDR_LEN
    glen = struct.unpack("<H", arc[off:off + 2])[0]
    return dict(block_size=1 << f[2], tbits=f[3], mbits=f[4], ibits=f[5],
                pbits=f[6], dmc_nodes=(1 << f[7]) if f[7] else 0,
                seg_size=1 << f[8], lstm_layers=f[9], lstm_horizon=f[10],
                lstm_hidden=f[11], exec_batch=f[12], blocks=f[15],
                gates=arc[off + 2:off + 2 + glen].decode())


def direction(argv, cuda):
    """``runner.main(argv)`` -> (seconds, dmc_fused launches, peak bytes)."""
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = dmc.launch_counts()[0]
    t0 = time.perf_counter()
    runner.main(argv)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else None
    return secs, dmc.launch_counts()[0] - before, peak


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    src, out_dir, opts = argv[0], argv[1], argv[2:]
    cuda = not ("--device" in opts
                and opts[opts.index("--device") + 1] == "cpu")
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.basename(src)
    arc_path = os.path.join(out_dir, name + ".tcmx")
    back_path = os.path.join(out_dir, name + ".back")
    with open(src, "rb") as f:
        data = f.read()
    secs, launches, peak = direction(["c", src, arc_path, "--stats"] + opts,
                                     cuda)
    with open(arc_path, "rb") as f:
        arc = f.read()
    hdr = header(arc)
    steps = hdr["block_size"] * -(-hdr["blocks"] // max(1, hdr["exec_batch"]))
    print(json.dumps(dict(
        mode="compress", input=name, bytes=len(data), s=secs,
        ms_per_step=secs / steps * 1e3,
        dmc_fused_launches=launches, peak_device_bytes=peak,
        archive_bytes=len(arc), bpb=8.0 * len(arc) / max(1, len(data)),
        sha256=hashlib.sha256(arc).hexdigest(), header=hdr)), flush=True)
    dev = ["--device", "cpu"] if not cuda else []
    secs, launches, peak = direction(
        ["d", arc_path, back_path, "--stats"] + dev, cuda)
    with open(back_path, "rb") as f:
        exact = f.read() == data
    print(json.dumps(dict(
        mode="decompress", input=name, bytes=len(data), s=secs,
        ms_per_step=secs / steps * 1e3,
        dmc_fused_launches=launches, peak_device_bytes=peak, exact=exact)),
        flush=True)
    if cuda:
        print(f"card: {card()}", flush=True)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
