"""The benchmark's frozen bound functions count what the port's own
checks (chip_smoke.py) counted, on the same small inputs."""
import pytest
import torch

import bench_testutil  # noqa: F401
import bounds


@pytest.mark.parametrize("ny,nx,ndte", [(24, 16, 8), (384, 320, 120),
                                        (1080, 1440, 120)])
def test_evp_bound(ny, nx, ndte):
    import chip_smoke
    ms, by, _ = chip_smoke.evp_bound({"uvel": torch.zeros(ny, nx)}, ndte)
    assert bounds.evp_bound(ny, nx, ndte) == (ms, by)
    assert bounds.evp_bound(ny, nx, ndte, 8)[0] > ms


def _remap_args(seed, ncat=5, ntrace=7, ny=12, nx=10):
    g = torch.Generator().manual_seed(seed)
    mm = torch.rand((ncat, ny + 4, nx + 4), generator=g)
    mm = torch.where(mm > 0.6, mm, 0.0)
    tm = torch.rand((ncat, ntrace, ny + 4, nx + 4), generator=g)
    tt = [1, 1, 2, 1, 2, 3, 3]
    par = [0, 0, 1, 0, 3, 2, 4]
    return (None, None, mm, tm, mm, tt, par, ny, nx)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_remap_bound(seed):
    import chip_smoke
    args = _remap_args(seed)
    for edges in (("north", "east"), ("north",)):
        ms, by, _ = chip_smoke.remap_bound(args, edges)
        assert bounds.remap_bound(args, edges) == (ms, by)


@pytest.mark.parametrize("layers", [(4, 1), (7, 1), (8, 3)])
def test_dedd_bound(layers):
    import chip_smoke
    g = torch.Generator().manual_seed(sum(layers))
    ncat, ny, nx = 5, 9, 7
    u = lambda *s: torch.rand(s, generator=g)
    kw = dict(aicen=torch.where(u(ncat, ny, nx) > 0.3, u(ncat, ny, nx), 0.0),
              coszen=u(ny, nx) - 0.3, swvdr=u(ny, nx), swvdf=u(ny, nx),
              swidr=u(ny, nx), swidf=u(ny, nx), nilyr=layers[0],
              nslyr=layers[1])
    ms, by, _ = chip_smoke.dedd_bound(kw)
    assert bounds.dedd_bound(kw) == (ms, by)
    assert torch.equal(bounds.dedd_lit(kw), chip_smoke.dedd_lit(kw))
