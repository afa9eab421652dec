"""peak_device_gib (GiB): ``torch.cuda.max_memory_allocated()`` over
set-up and window, the port's and the benchmark's inputs together."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return ctx.memory_peak_bytes / 2 ** 30
