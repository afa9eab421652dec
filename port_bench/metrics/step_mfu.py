"""step_mfu (%, host clock; layer: step orchestration and step graphs;
moves sypd): the whole step's share of the H100's peaks: the least time
of the step's work (``step_work``: kernels A, B and C on a sampled
step's inputs, each the larger of its operations over 67 TFLOP/s and its
bytes over 3.35 TB/s, and the model state read and written once, summed)
over the measured ms per step of the window."""
from step_work import step_least_ms


def read(ctx):
    c = ctx.counters
    if not ctx.args.trace or not c.get("steps"):
        return None
    ms_per_step = 1e3 * c["wall_s"] / c["steps"]
    return 100.0 * step_least_ms(ctx) / ms_per_step
