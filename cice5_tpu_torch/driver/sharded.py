"""The model over a mesh of ranks (PyTorch port of
``cice5_tpu/driver/sharded.py``).

The reference scales by MPI rank decomposition (ice_domain.F90 block
distribution). Here one ``torch.distributed`` process runs per tile of a
(py, px) mesh (``parallel/mesh.py``); each runs the eager step
``driver.step.step`` on its tile, the halo exchanges of
``parallel/halo.py`` and the global reductions going through the process
group. The same class runs over NCCL with one card per rank, over gloo
with several ranks on one card, and over gloo on the CPU::

    initialize_distributed("nccl")           # once per process
    sm = ShardedModel(cfg)                   # a tile per rank
    state = sm.init_state()                  # this rank's tile
    state = sm.run(state, nsteps=24)         # run_loop; rank 0 writes
    host = sm.gather(state)                  # global NumPy on every rank

Every rank builds the global grid, initial state and forcing, and keeps
its tile (``put``). The kernels of the step (B, the remap; C, the
delta-Eddington shortwave) run on the tile; the EVP runs the subcycle
loop with one halo exchange per subcycle (or ``evp_chunked``), as the JAX
step does on a mesh, never kernel A or D. The step is not captured as a
CUDA graph.
"""
from __future__ import annotations

from cice5_tpu_torch.config import ModelConfig
from cice5_tpu_torch.driver.model import Model, run_loop
from cice5_tpu_torch.driver.step import step as step_fn
from cice5_tpu_torch.grid import Grid
from cice5_tpu_torch.parallel import distributed as pdist
from cice5_tpu_torch.parallel.mesh import make_mesh, mesh_topology


class ShardedModel:
    """``Model`` on this rank's tile of a (py, px) mesh of ranks.

    mesh_shape: (py, px), default ``best_mesh_shape`` of the world size;
    grid: optional pre-built global Grid, as for ``Model``; device: this
    rank's device, None for CUDA (the current card; raises without one),
    ``"cpu"`` for the CPU. ``torch.distributed`` must be initialized
    (``parallel.distributed.initialize_distributed``)."""

    def __init__(self, cfg: ModelConfig, mesh_shape=None,
                 grid: Grid | None = None, device=None):
        self.inner = Model(cfg, grid=grid, device=device)
        self.cfg = cfg
        self.device = self.inner.device
        self.grid = self.inner.grid          # global, for the I/O layer
        self.tr = self.inner.tr
        self.calendar = self.inner.calendar
        self.mesh = make_mesh(cfg.grid.ny, cfg.grid.nx, shape=mesh_shape,
                              device=self.device)
        self.topo = mesh_topology(self.mesh, ew=cfg.grid.ew_boundary,
                                  ns=cfg.grid.ns_boundary)
        self.tile_grid = self.put(self.grid)
        self.writes_files = pdist.is_primary()

    @property
    def step_args(self) -> tuple:
        """The arguments of ``driver.step.step`` after (state, forcing),
        on this rank's tile."""
        inner = self.inner
        return (self.tile_grid, self.cfg, self.tr, self.topo, inner.hin_max,
                inner.salinz)

    def put(self, tree):
        """This rank's tile of a global tree (State, Forcing, Grid, a
        tensor ...) on the rank's device."""
        return pdist.put(tree, self.mesh, self.device)

    def init_state(self, **kw):
        return self.put(self.inner.init_state(**kw))

    @property
    def forcing_provider(self):
        return self.inner.forcing_provider

    @forcing_provider.setter
    def forcing_provider(self, fn):
        self.inner.forcing_provider = fn

    def forcing_at(self, istep: int):
        return self.put(self.inner.forcing_at(istep))

    def step(self, state, forcing):
        """One eager step on the tile; returns (state, diag) tiles. Every
        rank must call it: its exchanges and reductions are collective."""
        return step_fn(state, forcing, *self.step_args)

    def run(self, state, nsteps: int, **kw):
        """``run_loop`` on the tiles: diagnostics, history, restarts and
        state checks gather to global tensors at the I/O boundaries; only
        the primary rank writes files."""
        return run_loop(self, state, nsteps, **kw)

    def global_view(self, tree):
        """The global tensors of a tree of tiles, on every rank
        (collective)."""
        return pdist.gather(tree, self.mesh)

    def gather(self, tree):
        """A tree of tiles as global host NumPy arrays, on every rank."""
        return pdist.to_host(tree, self.mesh)
