"""Device operations (kernels, copies, fills) per byte step, from the
torch.profiler trace of TRACE_REPLAYS graph replays of one encode call."""


def read(ctx):
    t = ctx["trace"]
    return None if t is None else t["ops_per_step"]
