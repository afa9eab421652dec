"""remap_flux_both_roofline (%, device trace; layer: kernels; moves sypd):
in the standalone cells, the least time of kernel B (the remap fluxes of both edge sets, csrc/remap_tiles.cu) on the inputs of the
traced window's first step, as ``bounds.remap_bound`` counts it against the
H100's published peaks, over the kernel's mean device time per launch in
the traced window (``step_work.roofline``)."""
from step_work import roofline


def read(ctx):
    return roofline(ctx, "remap_tiles", "remap_flux_both")
