"""The port stands alone: it imports neither jax nor the JAX package, and
none of its entry points looks for a GPU and carries on without one."""

import pkgutil
import subprocess
import sys
import os

import pytest
import torch

import noahmp_tpu_torch
from noahmp_tpu_torch import Options, load_params, make_step
from noahmp_tpu_torch.kernels.tridiag import thomas_cuda
from noahmp_tpu_torch.state import init_state, init_static

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER_MODULES = ("io", "run", "cli", "merge", "geo", "config", "netcdf",
                  "solar", "multihost")
DIST_MODULES = ("mesh", "checkpoint")


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        noahmp_tpu_torch.__path__, prefix="noahmp_tpu_torch."))


def _bench_modules():
    import benchmarks_torch
    return ["benchmarks_torch"] + sorted(m.name for m in pkgutil.walk_packages(
        benchmarks_torch.__path__, prefix="benchmarks_torch."))


def test_fresh_interpreter_imports_no_jax():
    mods = ["noahmp_tpu_torch"] + _submodules() + _bench_modules()
    assert "benchmarks_torch.run" in mods
    assert "noahmp_tpu_torch.physics.sflx" in mods
    assert "noahmp_tpu_torch.kernels.tridiag" in mods
    assert "noahmp_tpu_torch.physics.carbon" in mods
    assert "noahmp_tpu_torch.utils" in mods
    for name in DRIVER_MODULES:
        assert f"noahmp_tpu_torch.driver.{name}" in mods
    for name in DIST_MODULES:
        assert f"noahmp_tpu_torch.dist.{name}" in mods
    assert "noahmp_tpu_torch.native" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'noahmp_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_utils_reachable_from_the_package():
    """``noahmp_tpu_torch.utils`` after ``import noahmp_tpu_torch``, as
    ``noahmp_tpu.utils`` is in the JAX package (a fresh interpreter: no
    other import may have loaded the submodule first)."""
    code = ("import noahmp_tpu_torch as p\n"
            "assert 'utils' in p.__all__\n"
            "print(p.utils.ConservationError.__name__)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ConservationError"


def test_console_scripts_declared():
    """pyproject.toml declares the port's CLI beside the JAX package's,
    and the function it names exists."""
    import tomllib
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    assert scripts["noahmp-tpu"] == "noahmp_tpu.driver.cli:main"
    assert scripts["noahmp-tpu-torch"] == "noahmp_tpu_torch.driver.cli:main"
    from noahmp_tpu_torch.driver import cli
    assert callable(cli.main)


@pytest.mark.parametrize("entry", ["make_mesh", "multihost.main"])
def test_dist_default_device_is_the_card(entry, tmp_path):
    """dist's entry points run on the card unless asked for the CPU:
    without one they raise before they make any process group."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    import torch.distributed as dist
    from noahmp_tpu_torch.dist.mesh import make_mesh
    from noahmp_tpu_torch.driver import multihost
    calls = {"make_mesh": make_mesh,
             "multihost.main": lambda: multihost.main(
                 [str(tmp_path / "case.nml")])}
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert not dist.is_initialized()


def test_sources_name_no_jax_import():
    """Static check of the same: no import statement of jax or of the
    JAX package in the port, in its measured entry points
    (benchmarks_torch/), in chip_smoke.py or in the script it imports."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|noahmp_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "canopy_trips.py")]
    for top in (os.path.dirname(noahmp_tpu_torch.__file__),
                os.path.join(ROOT, "benchmarks_torch")):
        for base, _dirs, names in os.walk(top):
            files += [os.path.join(base, f) for f in names
                      if f.endswith(".py")]
    assert os.path.join(ROOT, "benchmarks_torch", "spinup.py") in files
    assert len(files) > 20
    assert os.path.join(os.path.dirname(noahmp_tpu_torch.__file__), "native",
                        "__init__.py") in files
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path


@pytest.mark.parametrize("entry", ["load_params", "init_state",
                                   "init_static", "make_step",
                                   "make_chunk_step", "make_simulate",
                                   "simulate"])
def test_default_device_is_the_card(entry):
    """device=None means CUDA: without a card every entry point raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    calls = {
        "load_params": lambda: load_params(),
        "init_state": lambda: init_state(4),
        "init_static": lambda: init_static(4),
        "make_step": lambda: make_step(load_params(device="cpu"),
                                       Options(), 900.0),
        "make_chunk_step": lambda: noahmp_tpu_torch.make_chunk_step(
            load_params(device="cpu"), Options(), 900.0),
        "make_simulate": lambda: noahmp_tpu_torch.make_simulate(
            load_params(device="cpu"), Options(), 900.0),
        "simulate": lambda: noahmp_tpu_torch.simulate(
            load_params(device="cpu"), Options(), 900.0,
            init_static(2, device="cpu"), None, init_state(2, device="cpu")),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_thomas_cuda_refuses_cpu_tensor():
    x = torch.ones(8, 4)
    before = thomas_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        thomas_cuda(x, x, x, x)
    assert thomas_cuda.launches == before


def test_step_refuses_tensors_on_another_device():
    step = make_step(load_params(device="cpu"), Options(), 900.0,
                     device="cpu")
    static = init_static(2, device="cpu")
    state = init_state(2, device="cpu")
    meta = state._replace(tg=state.tg.to("meta"))
    from noahmp_tpu_torch.cases import uniform_case, to_device
    _, forcing, _ = to_device(uniform_case(2), "cpu")
    with pytest.raises(ValueError, match="built for"):
        step(static, forcing, meta)


def test_importing_builds_nothing():
    """nvcc, g++ and ctypes are touched at first launch, never at
    import."""
    build_dir = os.path.join(os.path.dirname(noahmp_tpu_torch.__file__),
                             "_build")
    from noahmp_tpu_torch import native
    from noahmp_tpu_torch.kernels import _build
    # the oracle's library: built on first use, into the port's build
    # directory, never beside its sources
    assert native._lib is None
    assert native.library_path().startswith(build_dir)
    assert _build.sources() == ["column", "issue_probe", "tridiag"]
    # the carbon header is among the files the libraries' hash covers
    assert "carbon.cuh" in os.listdir(_build.CSRC_DIR)
    with open(os.path.join(_build.CSRC_DIR, "sflx.cuh")) as fh:
        assert '#include "carbon.cuh"' in fh.read()
    for name in _build.sources():
        assert _build.library_path(name).startswith(build_dir)
    if not torch.cuda.is_available():
        assert not os.path.exists(build_dir) or not os.listdir(build_dir)


def _offline_case(tmp_path):
    """A 4-point case on disk: domain, init, a restart and a namelist."""
    import datetime
    import numpy as np
    from noahmp_tpu_torch.cases import conus_case
    from noahmp_tpu_torch.driver import io
    case = conus_case(4, seed=0, days=1, outdir=str(tmp_path / "case"))
    io.save_restart(str(tmp_path / "restart.nc"), init_state(4, device="cpu"),
                    datetime.datetime(2000, 7, 1))
    geo_em = str(tmp_path / "geo_em.nc")
    io.netcdf.write_classic(geo_em, {
        "XLAT_M": np.full((1, 2, 2), 40.0, np.float32),
        "LU_INDEX": np.full((1, 2, 2), 7.0, np.float32)})
    return case, str(tmp_path / "restart.nc"), geo_em


@pytest.mark.parametrize("entry", ["io.load_domain", "io.load_init",
                                   "io.load_restart", "run.run_offline",
                                   "cli.main", "geo.static_from_geo_em"])
def test_driver_default_device_is_the_card(entry, tmp_path):
    """The offline driver's entry points that put tensors on a device
    raise without a card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    from noahmp_tpu_torch.driver import cli, geo, io, run
    from noahmp_tpu_torch.driver.config import Config
    case, restart, geo_em = _offline_case(tmp_path)
    nml = os.path.join(case, "case.nml")
    calls = {
        "io.load_domain": lambda d: io.load_domain(
            os.path.join(case, "domain.nc"), **d),
        "io.load_init": lambda d: io.load_init(
            os.path.join(case, "init.nc"), 4, **d),
        "io.load_restart": lambda d: io.load_restart(restart, **d),
        "run.run_offline": lambda d: run.run_offline(
            Config.from_namelist(nml), verbose=False, chunk_steps=1,
            **d) if not d else None,
        "cli.main": lambda d: cli.main([nml] + (
            ["--device", d["device"]] if d else [])) if not d else None,
        "geo.static_from_geo_em": lambda d: geo.static_from_geo_em(
            geo_em, **d),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]({})
    calls[entry]({"device": "cpu"})


@pytest.mark.parametrize("name", ["merge", "config", "netcdf", "solar"])
def test_host_only_driver_modules_never_look_for_a_card(name):
    """config, netcdf, solar and merge hold numpy and files only: they
    place nothing on a device and never ask whether there is one."""
    import importlib
    mod = importlib.import_module(f"noahmp_tpu_torch.driver.{name}")
    with open(mod.__file__) as fh:
        source = fh.read()
    for word in ("cuda", "is_available", "torch.device", "import torch"):
        assert word not in source, (name, word)
