"""shortwave_dedd_roofline (%, device trace; layer: kernels; moves sypd):
in the standalone cells, the least time of kernel C (the delta-Eddington shortwave, csrc/shortwave_dedd.cu) on the inputs of the
traced window's first step, as ``bounds.dedd_bound`` counts it against the
H100's published peaks, over the kernel's mean device time per launch in
the traced window (``step_work.roofline``)."""
from step_work import roofline


def read(ctx):
    return roofline(ctx, "shortwave_dedd", "shortwave_dedd")
