"""sypd (years/day, host clock): simulated years per wall-clock day, all
the simulated time of the window over all its wall time: steps x dt /
(365 x 86400 s) per 86400 s of wall time."""


def read(ctx):
    c = ctx.counters
    return c["steps"] * ctx.model_spec["time"]["dt"] / (365.0 * c["wall_s"])
