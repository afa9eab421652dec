"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU at a tiny size (the harness's look for a card skipped):
a sound run is correct; a step broken underneath the timed path is not,
whether the fault is broad or confined to a part of the field; the
control (the reference one precision below the configuration's) fails
the limits."""
import dataclasses

import pytest
import torch

from bench_testutil import CELLS, run_tiny


def _unchanged(real):
    def step(state, forcing, *a):
        _, diag = real(state, forcing, *a)
        return state, diag
    return step


def _half(real):
    """Half the grid's rows left unstepped."""
    def step(state, forcing, *a):
        new, diag = real(state, forcing, *a)
        ny = state.aicen.shape[-2]
        kw = {}
        for f in dataclasses.fields(new):
            v, old = getattr(new, f.name), getattr(state, f.name)
            if torch.is_tensor(v) and v.dim() >= 2:
                v = v.clone()
                v[..., : ny // 2, :] = old[..., : ny // 2, :]
            kw[f.name] = v
        return new.replace(**kw), diag
    return step


def _altered(real):
    """The ocean heat flux altered where the step makes it."""
    def step(state, forcing, *a):
        new, diag = real(state, forcing, *a)
        return new, diag._replace(fhocn=1.5 * diag.fhocn)
    return step


def _local(region):
    """The ice volume 1% high where ``region(vicen, grid)`` holds, and
    right elsewhere: a fault that touches under a quarter of the cells."""
    def fault(real):
        def step(state, forcing, grid, *a):
            new, diag = real(state, forcing, grid, *a)
            f = torch.where(region(new.vicen, grid), 1.01, 1.0)
            f = f.to(new.vicen.dtype)
            return new.replace(vicen=new.vicen * f,
                               vsnon=new.vsnon * f), diag
        return step
    return fault


def _rows(v, lo, hi):
    ny = v.shape[-2]
    r = torch.arange(ny, device=v.device)[:, None]
    return ((r >= lo % ny) & (r < (hi - 1) % ny + 1)).expand(v.shape[-2:])


LOCAL = {
    # one thickness category of five
    "one_category": lambda v, g: (torch.arange(v.shape[0], device=v.device)
                                  == 2)[:, None, None].expand(v.shape),
    # the row next to the tripole fold
    "fold_row": lambda v, g: _rows(v, -1, 0).expand(v.shape),
    # one 2x8 tile of the northern ice
    "one_tile": lambda v, g: (_rows(v, -3, -1) & (torch.arange(
        v.shape[-1], device=v.device) < 8)).expand(v.shape),
    # the southern hemisphere's ice
    "one_hemisphere": lambda v, g: (g.TLAT < 0).expand(v.shape),
}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run_tiny(cell)
    assert out["correct"] is True
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(monkeypatch, cell, fault):
    import cice5_tpu_torch.driver.model as model
    monkeypatch.setattr(model, "step_fn", fault(model.step_fn))
    out = run_tiny(cell)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"]


@pytest.mark.parametrize("region", sorted(LOCAL))
@pytest.mark.parametrize("cell", CELLS)
def test_local_fault_is_not_correct(monkeypatch, cell, region):
    """A fault in under a quarter of the ice moves a block's total,
    whatever the quartile reads."""
    import cice5_tpu_torch.driver.model as model
    monkeypatch.setattr(model, "step_fn",
                        _local(LOCAL[region])(model.step_fn))
    out = run_tiny(cell)
    assert out["correct"] is False
    got = out["checks"]["state_block_gap"]
    assert got["value"] > got["limit"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    out = run_tiny(cell, control=1)
    checks = out["checks"]
    failed = [k for k, v in checks.items() if k.startswith("control.")
              and not v["value"] <= v["limit"]]
    assert failed, checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card_at_the_cells_size(cuda, cell):
    import run
    from bench_testutil import ROOT
    args = run.parse_args(["--workload", cell, "--seed", "2500000041",
                           "--seconds", "5", "--control", "1"])
    files = run.cell_files(run.load_json(ROOT / "BENCHMARK.json"), cell)
    out = run.run_cell(files, args, "cuda:0")
    assert out["correct"] is True
    assert any(not v["value"] <= v["limit"]
               for k, v in out["checks"].items()
               if k.startswith("control."))
