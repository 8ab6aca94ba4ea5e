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


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        noahmp_tpu_torch.__path__, prefix="noahmp_tpu_torch."))


def test_fresh_interpreter_imports_no_jax():
    mods = ["noahmp_tpu_torch"] + _submodules()
    assert "noahmp_tpu_torch.physics.sflx" in mods
    assert "noahmp_tpu_torch.kernels.tridiag" in mods
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


def test_sources_name_no_jax_import():
    """Static check of the same: no import statement of jax or of the
    JAX package in the port or in chip_smoke.py."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|noahmp_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.dirname(
            noahmp_tpu_torch.__file__)):
        files += [os.path.join(base, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path


@pytest.mark.parametrize("entry", ["load_params", "init_state",
                                   "init_static", "make_step"])
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
    """nvcc and ctypes are touched at first launch, never at import."""
    build_dir = os.path.join(os.path.dirname(noahmp_tpu_torch.__file__),
                             "_build")
    from noahmp_tpu_torch.kernels import _build
    assert _build.sources() == ["column", "issue_probe", "tridiag"]
    for name in _build.sources():
        assert _build.library_path(name).startswith(build_dir)
    if not torch.cuda.is_available():
        assert not os.path.exists(build_dir) or not os.listdir(build_dir)
