"""Build the CUDA sources under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``: ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded
with ``ctypes``.  The hash covers every file under ``csrc/`` and the
flags, so an edited source is rebuilt and a stale library is never
loaded.  ``nvcc`` and ``ctypes.CDLL`` are touched only from
``load_library``, never at import, so the package imports on a machine
without the CUDA toolkit.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# per-source extra flags; both sources must round a product before the
# add that follows it, as the plain versions do (eager PyTorch never
# contracts a multiply and an add across two operations)
EXTRA_FLAGS = {"tridiag": ("--fmad=false",), "column": ("--fmad=false",)}

_LIBS = {}
_LOCK = threading.Lock()


def find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (looked on PATH and under CUDA_HOME)")
    return nvcc


def _source_hash(flags):
    h = hashlib.sha256(" ".join(flags).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def sources():
    """Names of the kernels' sources (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def library_path(name):
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    return os.path.join(BUILD_DIR, f"lib{name}-{_source_hash(flags)}.so")


def build_command(name, out):
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    return [find_nvcc(), *flags, "-o", out,
            os.path.join(CSRC_DIR, name + ".cu")]


def build_all(names=None):
    """Compile every named source (default: all of ``csrc/``) whose
    library is not there yet, one ``nvcc`` per source, all started
    together.  Returns {name: library path}."""
    names = sources() if names is None else list(names)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, out in paths.items():
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            procs[name] = (tmp, subprocess.Popen(
                build_command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{err}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load_library(name):
    """The ``ctypes`` library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build_all([name])[name])
        return lib
