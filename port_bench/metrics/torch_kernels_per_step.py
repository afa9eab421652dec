"""torch_kernels_per_step (kernels/step, device trace; layer: step
orchestration and step graphs; moves sypd): the device operations of the
traced window (kernels, copies and fills; the forcing made on the device
included) per step."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace["device_events"] / ctx.trace["steps"]
