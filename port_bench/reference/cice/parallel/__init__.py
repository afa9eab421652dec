from reference.cice.parallel.halo import (Topology, extend, extend_wide,
                                           extend_wide_groups, global_min,
                                           global_sum, interior, shifted)

__all__ = ["Topology", "extend", "extend_wide", "extend_wide_groups",
           "interior", "shifted", "global_sum", "global_min"]
