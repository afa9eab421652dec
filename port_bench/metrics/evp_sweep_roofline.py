"""evp_sweep_roofline (%, device trace; layer: kernels; moves sypd):
in the standalone cells, the least time of kernel A (the EVP sweep, csrc/evp_resident.cu) on the inputs of the
traced window's first step, as ``bounds.evp_bound`` counts it against the
H100's published peaks, over the kernel's mean device time per launch in
the traced window (``step_work.roofline``)."""
from step_work import roofline


def read(ctx):
    return roofline(ctx, "evp_resident", "evp_sweep")
