"""device_idle_pct (%, device trace; layer: device; moves sypd): 100 x (1 -
the device's busy time over the wall time of the same steps run
untraced). The traced steps run twice from the same state, untraced for
their wall time and under the profiler for the busy time (the union of
the device operations' intervals), since under the profiler each CUDA
graph launch takes longer on the host."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.get("untraced_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["untraced_s"])
