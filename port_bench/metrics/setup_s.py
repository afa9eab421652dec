"""setup_s (s, host clock): process start to the first timed step: the
imports, the kernels loaded (built on a checkout's first run), the grid,
the inputs, the initial state, the first eager step and the capture of
the step's CUDA graphs, and the warm-up. Moves: itself."""


def read(ctx):
    return ctx.setup_s
