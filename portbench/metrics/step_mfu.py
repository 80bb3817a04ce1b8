"""The whole byte step's share of the H100's float32 peak (67 TFLOP/s), in
%: the model FLOPs of one step at the cell's lanes (counts.step_flops, from
the configuration's shapes) over step_ms.enc."""

from portbench.harness import counts


def read(ctx):
    steps = sum(c["steps"] for c in ctx["enc"])
    dev = sum(c["phases"].get("device", 0.0) for c in ctx["enc"])
    if steps <= 0 or dev <= 0:
        return None
    flops = counts.step_flops(ctx["config"], ctx["sizes"], ctx["lanes"])
    return 100.0 * flops / (dev / steps) / counts.F32_FLOPS_PER_S
