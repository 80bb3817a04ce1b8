"""dmc_fused's share of its roofline, in %: the least time for the bytes
one launch needs at the cell's lanes and DMC depth (counts.dmc_fused_bytes,
chip_smoke.py's count, at the H100's 3.35 TB/s) over its device time a step
in the trace.  The count takes no valid descriptor, so the share is a
floor.  Nothing is read where the trace holds no dmc_fused launch."""

from portbench.harness import counts


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["steps"]:
        return None
    dev_s = sum(s for n, s in t["device_s"].items() if "dmc_fused" in n)
    if dev_s <= 0:
        return None
    least_s = (counts.dmc_fused_bytes(ctx["lanes"], ctx["levels"])
               / counts.HBM_BYTES_PER_S)
    return 100.0 * least_s / (dev_s / t["steps"])
