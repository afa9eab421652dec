"""Rules of the PyTorch port that need no numerics: it imports neither JAX
nor ``cice5_tpu``, ``Model`` refuses to fall back to the CPU, options
outside the port so far raise and the ported ones (the gx1-parity set)
pass, the kernel wrappers take CUDA tensors only, and the copied
configuration/calendar code matches the JAX package's."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from cice5_tpu import calendar as jcalendar
from cice5_tpu import config as jconfig
from cice5_tpu import constants as jconstants
from cice5_tpu.models.radiation import orbital as jorbital
from cice5_tpu.state import build_tracer_registry as jbuild
from cice5_tpu_torch import calendar as tcalendar
from cice5_tpu_torch import config as tconfig
from cice5_tpu_torch import constants as tconstants
from cice5_tpu_torch import convert
from cice5_tpu_torch.driver.model import Model, check_supported
from cice5_tpu_torch.models.radiation import orbital as torbital
from cice5_tpu_torch.ops import kernels
from cice5_tpu_torch.state import build_tracer_registry as tbuild

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "cice5_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_sharded_worker.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "cice5_tpu"), (path, n)


def test_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(tconfig.bench_easy_config(ny=8, nx=8, ndte=2))


def test_model_on_cpu_when_asked():
    m = Model(tconfig.bench_easy_config(ny=8, nx=8, ndte=2), device="cpu")
    assert m.device.type == "cpu" and m.grid.hm.device.type == "cpu"


@pytest.mark.parametrize("builder", ["make_grid", "zeros_state", "forcing",
                                     "state_from_arrays"])
def test_builders_need_an_explicit_device(builder):
    """No builder quietly picks the CPU: leaving the device out is an
    error."""
    from cice5_tpu_torch.forcing import idealized_polar_forcing
    from cice5_tpu_torch.grid import make_grid
    from cice5_tpu_torch.state import zeros_state
    cfg = tconfig.bench_easy_config(ny=8, nx=8, ndte=2)
    call = {"make_grid": lambda: make_grid(cfg),
            "zeros_state": lambda: zeros_state(cfg, tbuild(cfg)),
            "forcing": lambda: idealized_polar_forcing((8, 8), 1.0),
            "state_from_arrays": lambda: convert.state_from_arrays({})}
    with pytest.raises(TypeError, match="device"):
        call[builder]()


def _unsupported():
    base = tconfig.rect_config(ny=8, nx=8)
    r = dataclasses.replace
    return {
        "compact": base.replace(grid=r(base.grid, compact_columns="on")),
        "grid_type_unknown": base.replace(grid=r(base.grid,
                                                 grid_type="bipolar")),
    }


@pytest.mark.parametrize("name", sorted(_unsupported()))
def test_options_outside_the_slice_raise(name):
    with pytest.raises(NotImplementedError, match="slice"):
        check_supported(_unsupported()[name])


def _ported():
    r = dataclasses.replace
    parity = tconfig.gx1_parity_config()
    easy = tconfig.bench_easy_config()
    base = tconfig.rect_config(ny=8, nx=8)
    return {
        "gx1_parity": parity,
        "gx1_parity_f64": tconfig.gx1_parity_config(dtype="float64",
                                                    accum_dtype="float64"),
        # the JAX step sends "pallas" on a tripole seam to evp
        "gx1_parity_pallas": parity.replace(dyn=r(parity.dyn,
                                                  evp_algorithm="pallas")),
        "bench_easy": easy,
        "bench_easy_fused": easy.replace(dyn=r(easy.dyn,
                                               evp_algorithm="pallas")),
        "rect": tconfig.rect_config(ny=8, nx=8),
        # K subcycles per halo exchange, on one device or a mesh of ranks
        # (tests/test_torch_sharded.py holds it against JAX)
        "chunked": base.replace(dyn=r(base.dyn, evp_algorithm="chunked")),
        # the coupled-mode options, alone and together
        "formdrag": easy.replace(forcing=r(easy.forcing, formdrag=True)),
        "highfreq": parity.replace(forcing=r(parity.forcing,
                                             highfreq=True)),
        "coupled_radiation": parity.replace(coupled_radiation=True),
        "fbot_Cdn_ocn": easy.replace(thermo=r(easy.thermo,
                                              fbot_xfer_type="Cdn_ocn")),
        "auscom_025_coupled": tconfig.auscom_025_config(
            coupled_radiation=True, forcing=r(parity.forcing, formdrag=True,
                                              highfreq=True)),
        "tx01": tconfig.tx01_config(),
        # the standalone configurations and the column options, each on
        # its own (tests/test_torch_options.py holds each against JAX)
        "gx3": tconfig.gx3_config(),
        "tp1": tconfig.tp1_config(),
        "column": tconfig.column_config(),
        "popgrid": base.replace(grid=r(base.grid,
                                       grid_type="displaced_pole")),
        "latlon": base.replace(grid=r(base.grid, grid_type="latlon"),
                               dyn=r(base.dyn, kdyn=0, advection="none")),
        "cpom": base.replace(grid=r(base.grid, grid_type="cpom")),
        "zerolayer": base.replace(thermo=r(base.thermo, ktherm=0)),
        "calc_Tsfc": base.replace(thermo=r(base.thermo, calc_Tsfc=False)),
        "dEdd": base.replace(shortwave=r(base.shortwave, shortwave="dEdd"),
                             tracers=r(base.tracers, tr_pond_topo=True)),
        "iage": base.replace(tracers=r(base.tracers, tr_iage=True,
                                       tr_pond_cesm=True)),
        "tripole_seam_alone": base.replace(
            grid=r(base.grid, ns_boundary="tripole")),
        "mushy_alone": base.replace(thermo=r(base.thermo, ktherm=2)),
        "dEdd_alone": base.replace(
            shortwave=r(base.shortwave, shortwave="dEdd")),
        "iage_FY_alone": base.replace(
            tracers=r(base.tracers, tr_iage=True, tr_FY=True)),
        "pond_lvl_alone": base.replace(
            tracers=r(base.tracers, tr_lvl=True, tr_pond_lvl=True)),
        "parity_without_ponds": parity.replace(
            tracers=r(parity.tracers, tr_pond_lvl=False)),
        "parity_cesm_lid": parity.replace(
            tracers=r(parity.tracers, frzpnd="cesm")),
        "parity_ccsm3": parity.replace(
            shortwave=r(parity.shortwave, shortwave="ccsm3")),
        "parity_topo_ponds": tconfig.gx1_parity_config(
            tracers=r(parity.tracers, tr_pond_lvl=False,
                      tr_pond_topo=True)),
        # the dynamics and transport options, each on its own
        # (tests/torch_option_sets.py holds each against JAX)
        "tripole": base.replace(grid=r(base.grid, ns_boundary="tripoleT")),
        "eap": base.replace(dyn=r(base.dyn, kdyn=2)),
        "upwind": base.replace(dyn=r(base.dyn, advection="upwind")),
        "conserv_check": base.replace(dyn=r(base.dyn, conserv_check=True)),
        "monotonicity_check": base.replace(
            dyn=r(base.dyn, monotonicity_check=True)),
        "diag_mechred": base.replace(dyn=r(base.dyn, diag_mechred=True)),
        "dynamics_without_transport": base.replace(
            dyn=r(base.dyn, advection="none")),
        "eap_tfold": base.replace(grid=r(base.grid, ns_boundary="tripoleT"),
                                  dyn=r(base.dyn, kdyn=2)),
        # the aerosol, brine and skeletal-BGC tracers (the tracer sets of
        # tests/torch_option_sets.py hold them against JAX)
        "mushy+brine": base.replace(thermo=r(base.thermo, ktherm=2),
                                    tracers=r(base.tracers, tr_brine=True)),
        "skl_bgc": base.replace(tracers=r(base.tracers, skl_bgc=True)),
        "aero": base.replace(tracers=r(base.tracers, tr_aero=True,
                                       n_aero=1)),
        "gx1_bgc": tconfig.gx1_parity_config(tracers=r(
            parity.tracers, tr_aero=True, n_aero=3, tr_brine=True,
            skl_bgc=True)),
    }


@pytest.mark.parametrize("name", sorted(_ported()))
def test_ported_options_are_accepted(name):
    check_supported(_ported()[name])


def test_unknown_thermo_and_pond_refreezing_raise():
    r = dataclasses.replace
    base = tconfig.rect_config(ny=8, nx=8)
    with pytest.raises(ValueError, match="ktherm"):
        check_supported(base.replace(thermo=r(base.thermo, ktherm=3)))
    with pytest.raises(ValueError, match="frzpnd"):
        check_supported(base.replace(tracers=r(
            base.tracers, tr_lvl=True, tr_pond_lvl=True, frzpnd="x")))


def _fused_refusals():
    r = dataclasses.replace
    easy = tconfig.bench_easy_config()
    fused = easy.replace(dyn=r(easy.dyn, evp_algorithm="pallas"))
    return {
        "cyclic_ns": (fused.replace(grid=r(fused.grid, ns_boundary="cyclic")),
                      "open-boundary dynamics"),
        "ndte_not_multiple_of_10": (fused.replace(dyn=r(fused.dyn, ndte=25)),
                                    "multiple of 10"),
    }


@pytest.mark.parametrize("name", sorted(_fused_refusals()))
def test_fused_evp_refusals_name_their_reason(name):
    """Two refusals of the fused EVP path that no later slice lifts: the
    JAX fused kernel computes open-boundary dynamics on a cyclic
    north-south grid, and runs chunks of 10 subcycles."""
    cfg, reason = _fused_refusals()[name]
    with pytest.raises(NotImplementedError, match=reason):
        check_supported(cfg)


def test_parity_model_on_cpu_and_without_cuda(monkeypatch):
    """Model(gx1_parity_config(), grid=synth_gx1_grid(...)) builds on the
    CPU when asked, and raises without a GPU otherwise; make_grid asks a
    POP configuration without grid files for them."""
    from cice5_tpu_torch.grid import make_grid, synth_gx1_grid
    cfg = tconfig.gx1_parity_config()
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, ny=24, nx=16))
    g = synth_gx1_grid(cfg, device="cpu")
    m = Model(cfg, grid=g, device="cpu")
    st = m.init_state()
    assert float(st.aicen.sum(0).max()) > 0.9
    tr = m.tr
    has = st.aicen > 0
    assert bool((st.trcrn[:, tr.nt_alvl][has] == 1).all())
    assert bool((st.trcrn[:, tr.nt_vlvl][has] == 1).all())
    # the polar land bands of the 384-row fallback mask, resampled to 24
    assert not bool(g.tmask[0].any()) and bool(g.tmask[1:].all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg, grid=g)
    with pytest.raises(ValueError, match="grid_file/kmt_file"):
        make_grid(cfg, device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    z = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.evp_sweep(ndte=1, cyc_x=True, cyc_y=False, u=z, v=z,
                          stress=z, maskR=z, strengthR=z, gR=z, uin=z,
                          cw_plane=False, Cw=0.0, p=None)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.shortwave_dedd(
            nilyr=4, nslyr=1, **{k: torch.zeros(1, 4, 4) for k in (
                "aicen", "vicen", "vsnon", "Tsfcn", "apnd", "hpnd")},
            **{k: z for k in ("coszen", "fnidr", "swvdr", "swvdf", "swidr",
                              "swidf")})
    with pytest.raises(ValueError, match="CUDA"):
        kernels.remap_flux_both(mmE2=torch.zeros(1, 8, 8),
                                tmE2=torch.zeros(1, 1, 8, 8), hmE2=z,
                                geomN=None, geomE=None, tracer_type=(1,),
                                parent=(-1,), ny=4, nx=4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.evp_fused(kchunk=10, cyc_x=True, u=z, v=z, stress=z,
                          maskR=z, strengthR=z, gR=z, uin=z, cw_plane=False,
                          Cw=0.0, p=None)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.remap_flux_edge(edge="north", mmE2=torch.zeros(1, 8, 8),
                                tmE2=torch.zeros(1, 1, 8, 8), hmE2=z,
                                geom=None, tracer_type=(1,), parent=(-1,),
                                ny=4, nx=4)


def test_kernel_build_targets_hopper():
    for k in kernels.KERNELS.values():
        assert k.source.exists()
        text = k.source.read_text()
        assert "Replaces:" in text and "Bound on the H100" in text
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def test_kernel_rebuilds_when_its_source_or_a_header_is_newer(tmp_path,
                                                               monkeypatch):
    """A library older than its .cu or than a csrc header the .cu includes
    is rebuilt; the two EVP kernels share one source and evp_point.cuh,
    and both remap kernels are built from remap_tiles.cu; kernel C has a
    library of its own for each pair of layer counts besides (4, 1) and
    (7, 1), built with the pair's macros."""
    import os
    monkeypatch.setenv("CICE5_TORCH_BUILD_DIR", str(tmp_path))
    d, a = kernels.KERNELS["evp_fused"], kernels.KERNELS["evp_sweep"]
    assert [h.name for h in d.headers()] == ["evp_point.cuh"] == \
        [h.name for h in a.headers()]
    assert d.library == a.library
    assert kernels.KERNELS["remap_flux_both"].library.name == \
        "libremap_tiles.so"
    assert kernels.KERNELS["remap_flux_edge"].library == \
        kernels.KERNELS["remap_flux_both"].library
    c = kernels.KERNELS["shortwave_dedd"]
    assert kernels.dedd_kernel(4, 1) is c is kernels.dedd_kernel(7, 1)
    c83 = kernels.dedd_kernel(8, 3)
    assert c83 is kernels.dedd_kernel(8, 3) and c83.source == c.source
    assert c83.library.name == "libshortwave_dedd_ni8_ns3.so"
    assert c.library.name == "libshortwave_dedd.so"
    assert c83.needs_build() and c83 in c.variants()
    assert d.needs_build()                       # no library yet
    header = d.headers()[0].stat().st_mtime
    newest = max(header, d.source.stat().st_mtime)
    d.library.touch()
    os.utime(d.library, (newest + 10, newest + 10))
    assert not d.needs_build()
    os.utime(d.library, (header - 10, header - 10))
    assert d.needs_build()


def test_config_copies_match_jax():
    for jc, tc in ((jconfig.ModelConfig(), tconfig.ModelConfig()),
                   (jconfig.gx1_parity_config(), tconfig.gx1_parity_config()),
                   (jconfig.rect_config(20, 30), tconfig.rect_config(20, 30))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jc = jconfig.rect_config(dtype="float64")
    assert convert.config_from_dict(dataclasses.asdict(jc)) == \
        tconfig.rect_config(dtype="float64")
    assert tconfig.bench_easy_config().xp_dtype == torch.float32
    for cfg in (jconfig.rect_config(), jconfig.gx1_parity_config()):
        tc = convert.config_from_dict(dataclasses.asdict(cfg))
        assert dataclasses.asdict(jbuild(cfg)) == \
            dataclasses.asdict(tbuild(tc))


def test_constants_calendar_orbit_match_jax():
    for name in dir(jconstants):
        v = getattr(jconstants, name)
        if isinstance(v, float):
            assert getattr(tconstants, name) == v, name
    jc, tc = jcalendar.Calendar(1997), tcalendar.Calendar(1997)
    for istep in (0, 1, 500, 9000):
        assert dataclasses.asdict(jc.info(istep, 3600.0)) == \
            dataclasses.asdict(tc.info(istep, 3600.0))
    assert tuple(jorbital.shr_orb_params(1950)) == \
        tuple(torbital.shr_orb_params(1950))


@pytest.mark.parametrize("days_per_year,use_leap_years",
                         [(365, True), (360, False), (360, True)])
def test_leap_and_360_day_calendars_match_jax(days_per_year,
                                              use_leap_years):
    """The calendars a namelist can ask for besides the no-leap default
    (``time.use_leap_years``, ``days_per_year``), as the Model builds
    them, against the JAX package's across the leap year 1996 and its
    seams: every date field equal."""
    cfg = tconfig.rect_config(ny=6, nx=6)
    cfg = cfg.replace(time=dataclasses.replace(
        cfg.time, year_init=1995, days_per_year=days_per_year,
        use_leap_years=use_leap_years))
    tc = Model(cfg, device="cpu").calendar
    jc = jcalendar.Calendar(1995, days_per_year, use_leap_years)
    leap = days_per_year == 365 and use_leap_years
    assert tc.use_leap_years == leap
    for day in (0, 364, 365, 424, 425, 730, 731, 1095, 1096, 1460):
        for istep in (24 * day, 24 * day + 23):
            assert dataclasses.asdict(jc.info(istep, 3600.0)) == \
                dataclasses.asdict(tc.info(istep, 3600.0)), istep
    if days_per_year == 365:
        # Feb 29 1996 exists only in the leap calendar
        d = tc.info(24 * (365 + 59), 3600.0)
        assert (d.year, d.month, d.mday) == ((1996, 2, 29) if leap
                                             else (1996, 3, 1))


def test_tensorclass_to_and_replace():
    m = Model(tconfig.bench_easy_config(ny=6, nx=6, ndte=2), device="cpu")
    st = m.init_state()
    st32 = st.to("cpu", dtype=torch.float64)
    assert st32.aicen.dtype == torch.float64
    assert st.replace(uvel=st.vvel).uvel is st.vvel
    arrays = convert.to_numpy(st)
    back = convert.state_from_arrays(arrays, device="cpu")
    assert all(np.array_equal(arrays[k], convert.to_numpy(back)[k])
               for k in arrays)
