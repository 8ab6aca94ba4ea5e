"""ctypes binding to the serial C++ reference column
(``native/noahmp_ref.cpp``): the oracle the port's steps are held to.

Counterpart of ``noahmp_tpu/native/__init__.py``, over the port's
``Params`` (buffers of an ``nn.Module``) and its Static, Forcing and
State tensors, on the card or on the CPU.  The C structs are the port's
own copies of the JAX binding's; their fields mirror
``native/noahmp_ref.hpp`` (``ColParams`` ... ``ColFlux``) byte for byte.

The library is built on first use, never at import, with the JAX
binding's compiler and flags (``g++ -O2 -shared -fPIC -fopenmp``; a
serial library where ``-fopenmp`` fails, which ``openmp()`` reports),
into ``noahmp_tpu_torch/_build/libnoahmp_ref-<hash>.so``.  The hash
covers the five sources under ``native/`` and the flags, so a stale
library is never loaded; nothing is written under ``native/``.

Every conversion reads a tensor to the host once per call, never once
per field or per column.  ``make_batch`` builds the four C arrays of a
whole batch as numpy structured arrays whose dtype is that of the
ctypes structs, filled column by column with vector operations; one
row holds the very bytes the per-column conversions write.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
import threading
import time

import numpy as np
import torch

from ..constants import MSNOW, NLEVELS, NSOIL
from ..options import Options
from ..state import Forcing, State, Static

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("noahmp_ref.cpp", "noahmp_ref.hpp", "noahmp_ref2.inc",
           "noahmp_ref3.inc", "noahmp_ref4.inc")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-fopenmp")

f = ct.c_float
i32 = ct.c_int32


class CColParams(ct.Structure):
    _fields_ = [
        ("nroot", i32),
        ("canwmxp", f), ("dleaf", f), ("z0mvt", f), ("hvt", f),
        ("hvb", f), ("rcrown", f), ("cwpvt", f), ("xl", f),
        ("rhol", f * 2), ("rhos", f * 2), ("taul", f * 2),
        ("taus", f * 2),
        ("lai12m", f * 12), ("sai12m", f * 12),
        ("tmin", f),
        ("c3c4", i32),
        ("kc25", f), ("akc", f), ("ko25", f), ("ako", f),
        ("vcmx25", f), ("avcmx", f), ("bp", f), ("mp", f), ("qe25", f),
        ("folnmx", f),
        ("rgl", f), ("hs", f), ("rsmax", f), ("rsmin", f), ("topt", f),
        ("sla", f), ("dilefc", f), ("dilefw", f), ("fragr", f),
        ("ltovrc", f), ("wrrat", f), ("wdpool", f), ("tdlef", f),
        ("rmf25", f), ("rms25", f), ("rmr25", f), ("arm", f), ("mrp", f),
        ("is_urban", i32), ("is_water", i32), ("is_barren", i32),
        ("is_ice_class", i32), ("is_egblf", i32),
        ("bexp", f), ("smcmax", f), ("smcref", f), ("smcwlt", f),
        ("psisat", f), ("dksat", f), ("dwsat", f), ("quartz", f),
        ("kdt", f), ("frzx", f),
        ("albsat", f * 2), ("albdry", f * 2),
        ("csoil", f), ("zbot", f), ("czil", f), ("timean", f),
        ("fsatmax", f), ("mltfct", f), ("z0sno", f), ("ssi", f),
        ("swemax", f),
        ("albice", f * 2), ("alblake", f * 2), ("omegas", f * 2),
        ("betads", f), ("betais", f),
        ("emssoil", f), ("emslake", f), ("slope", f),
        ("lat", f),
        ("ist", i32), ("ice", i32), ("isc", i32), ("slptyp", i32),
        ("zsoil", f * NSOIL),
        ("shdfac", f), ("shdmax", f), ("tbot", f), ("zlvl_ref", f),
    ]


class COpts(ct.Structure):
    _fields_ = [(k, i32) for k in
                ("veg", "crs", "btr", "run", "sfc", "frz", "inf", "rad",
                 "alb", "snf", "tbot", "stc")]


class CForcing(ct.Structure):
    _fields_ = [(k, f) for k in
                ("sfctmp", "sfcprs", "psfc", "uu", "vv", "q2", "soldn",
                 "lwdn", "prcp", "cosz", "co2air", "o2air", "foln",
                 "julian", "yearlen")]


class CState(ct.Structure):
    _fields_ = [
        ("canliq", f), ("canice", f), ("tv", f), ("eah", f), ("tah", f),
        ("fwet", f), ("lai", f), ("sai", f),
        ("tg", f), ("qsfc", f), ("cm", f), ("ch", f),
        ("nsnow", i32),
        ("snowh", f), ("sneqv", f), ("sneqvo", f),
        ("snice", f * MSNOW), ("snliq", f * MSNOW),
        ("zsnso", f * NLEVELS),
        ("albold", f), ("tauss", f),
        ("ficeold", f * MSNOW),
        ("qsnow", f),
        ("stc", f * NLEVELS),
        ("swc", f * NSOIL), ("smc", f * NSOIL),
        ("zwt", f), ("wa", f), ("wt", f), ("wslake", f),
        ("lfmass", f), ("rtmass", f), ("stmass", f), ("wood", f),
        ("stblcp", f), ("fastcp", f),
    ]


FLUX_FIELDS = ("fsa", "fsr", "fira", "fsh", "fcev", "fgev", "fctr",
               "ssoil", "trad", "ecan", "etran", "edir", "runsrf",
               "runsub", "apar", "psn", "sav", "sag", "fsno", "nee",
               "gpp", "npp", "fveg", "albedo", "qsnbot", "ponding",
               "rssun", "rssha", "t2mv", "t2mb", "q2v", "q2b", "fpice",
               "errwat", "errsw", "erreng")


class CFlux(ct.Structure):
    _fields_ = [(k, f) for k in FLUX_FIELDS]


# numpy views of the structs: one row of an array is one struct's bytes
PARAMS_DTYPE = np.dtype(CColParams)
FORCING_DTYPE = np.dtype(CForcing)
STATE_DTYPE = np.dtype(CState)
FLUX_DTYPE = np.dtype(CFlux)

# ColParams fields by where they come from
_VEG_BY_LUTYP = tuple(
    name for name, _ in CColParams._fields_[:CColParams._fields_.index(
        ("is_urban", i32))])
_CLASS_FLAGS = {"is_urban": "isurban", "is_water": "iswater",
                "is_barren": "isbarren", "is_ice_class": "isice",
                "is_egblf": "isegblf"}
_SOIL_BY_SLTYP = ("bexp", "smcmax", "smcref", "smcwlt", "psisat", "dksat",
                  "dwsat", "quartz", "kdt", "frzx")
_SOIL_BY_ISC = ("albsat", "albdry")
_GEN = ("csoil", "zbot", "czil", "timean", "fsatmax", "mltfct", "z0sno",
        "ssi", "swemax", "albice", "alblake", "omegas", "betads", "betais",
        "emssoil", "emslake")
_STATIC = {"lat": "lat", "ist": "ist", "ice": "ice", "isc": "isc",
           "slptyp": "slptyp", "zsoil": "zsoil", "shdfac": "shdfac",
           "shdmax": "shdmax", "tbot": "tbot", "zlvl_ref": "zlvl"}

_lib = None
_openmp = None
_LOCK = threading.Lock()


def _hash(flags):
    h = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as fh:
            h.update(name.encode())
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path(flags=CXX_FLAGS):
    return os.path.join(BUILD_DIR, f"libnoahmp_ref-{_hash(flags)}.so")


def _compile(flags, force=False):
    out = library_path(flags)
    if force or not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run(
            ["g++", *flags, "-o", tmp,
             os.path.join(NATIVE_DIR, "noahmp_ref.cpp")],
            cwd=NATIVE_DIR, capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed on native/noahmp_ref.cpp:\n"
                               f"{proc.stderr}")
        # a worker never loads a half-written library
        os.replace(tmp, out)
    return out


def build(force: bool = False) -> str:
    """Compile the shared library if missing/stale; returns its path."""
    global _openmp
    try:
        path, _openmp = _compile(CXX_FLAGS, force), True
    except RuntimeError:
        # toolchains without OpenMP: serial fallback
        serial = tuple(x for x in CXX_FLAGS if x != "-fopenmp")
        path, _openmp = _compile(serial, force), False
    return path


def load() -> ct.CDLL:
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ct.CDLL(build())
            lib.noahmp_step.argtypes = [
                ct.POINTER(CColParams), ct.POINTER(COpts),
                ct.POINTER(CForcing), f, ct.POINTER(CState),
                ct.POINTER(CFlux)]
            lib.noahmp_step.restype = None
            _lib = lib
        return _lib


def load_batch() -> ct.CDLL:
    lib = load()
    if not hasattr(lib.noahmp_step_batch, "_configured"):
        lib.noahmp_step_batch.argtypes = [
            ct.POINTER(CColParams), ct.POINTER(COpts),
            ct.POINTER(CForcing), f, ct.POINTER(CState),
            ct.POINTER(CFlux), ct.c_int64]
        lib.noahmp_step_batch.restype = None
        lib.noahmp_step_batch._configured = True
    return lib


def openmp() -> bool:
    """Whether the loaded library runs ``noahmp_step_batch`` on OpenMP
    threads (loads it)."""
    load()
    return _openmp


def set_threads(n: int):
    """Set OpenMP thread count for noahmp_step_batch (no-op if the
    library was built without OpenMP)."""
    lib = load()
    try:
        lib.omp_set_num_threads(ct.c_int(n))
    except AttributeError:
        pass


def _host(x):
    """One leaf as a host numpy array: one read of a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rows(tree, rows):
    """The leaves of a container at ``rows`` (a slice), on the host."""
    return {name: _host(leaf[rows]) for name, leaf in
            zip(tree._fields, tree)}


def _tables(params) -> dict:
    """Every table of ``params`` on the host, by table and field."""
    return {part: {name: _host(getattr(table, name))
                   for name in table.FIELDS}
            for part, table in (("veg", params.veg), ("soil", params.soil),
                                ("gen", params.gen))}


def params_to_array(params, static: Static, rows=slice(None)) -> np.ndarray:
    """ColParams of the points ``rows`` of ``static``, one row each."""
    t = _tables(params)
    v, s, g = t["veg"], t["soil"], t["gen"]
    st = _rows(static, rows)
    lu = st["lutyp"].astype(np.int64)
    sl = st["sltyp"].astype(np.int64)
    isc = st["isc"].astype(np.int64)
    slp = st["slptyp"].astype(np.int64)
    out = np.zeros(lu.shape[0], PARAMS_DTYPE)
    for name in _VEG_BY_LUTYP:
        out[name] = v[name][lu]
    for name, flag in _CLASS_FLAGS.items():
        out[name] = lu == int(v[flag])
    for name in _SOIL_BY_SLTYP:
        out[name] = s[name][sl]
    for name in _SOIL_BY_ISC:
        out[name] = s[name][isc]
    for name in _GEN:
        out[name] = g[name]
    out["slope"] = g["slope"][slp]
    for name, leaf in _STATIC.items():
        out[name] = st[leaf]
    return out


def forcing_to_array(forcing: Forcing, rows=slice(None)) -> np.ndarray:
    """ColForcing of the points ``rows``."""
    fr = _rows(forcing, rows)
    out = np.zeros(fr["sfctmp"].shape[0], FORCING_DTYPE)
    for name, _ in CForcing._fields_:
        out[name] = fr[name]
    return out


def state_to_array(state: State, rows=slice(None)) -> np.ndarray:
    """ColState of the points ``rows``."""
    sr = _rows(state, rows)
    out = np.zeros(sr["tg"].shape[0], STATE_DTYPE)
    for name, _ in CState._fields_:
        out[name] = sr[name]
    return out


def _struct(ctype, row):
    return ctype.from_buffer_copy(row.tobytes())


def gather_col_params(params, static: Static, i: int) -> CColParams:
    """Gather table values for column i into the flat C struct."""
    return _struct(CColParams, params_to_array(params, static,
                                               slice(i, i + 1)))


def opts_to_c(opts: Options) -> COpts:
    o = COpts()
    for name, _ in COpts._fields_:
        setattr(o, name, int(getattr(opts, name)))
    return o


def forcing_to_c(forcing: Forcing, i: int) -> CForcing:
    return _struct(CForcing, forcing_to_array(forcing, slice(i, i + 1)))


def state_to_c(state: State, i: int) -> CState:
    return _struct(CState, state_to_array(state, slice(i, i + 1)))


def state_from_c(cs: CState) -> dict:
    out = {}
    for name, typ in cs._fields_:
        v = getattr(cs, name)
        if hasattr(typ, "_length_"):
            out[name] = np.asarray(list(v), np.float32)
        else:
            out[name] = v
    return out


def step_column(params, opts: Options, static: Static,
                forcing: Forcing, state: State, i: int, dt: float):
    """Advance column i with the native reference.  Returns
    (state_dict, flux_dict)."""
    lib = load()
    cp = gather_col_params(params, static, i)
    co = opts_to_c(opts)
    cf = forcing_to_c(forcing, i)
    cs = state_to_c(state, i)
    cx = CFlux()
    lib.noahmp_step(ct.byref(cp), ct.byref(co), ct.byref(cf),
                    f(dt), ct.byref(cs), ct.byref(cx))
    flux = {k: float(getattr(cx, k)) for k in FLUX_FIELDS}
    return state_from_c(cs), flux


def make_batch(params, opts: Options, static: Static,
               forcing: Forcing, state: State):
    """Build C arrays for a whole batch: (COpts, ColParams, ColForcing,
    ColState, ColFlux), the last four numpy structured arrays of n
    rows."""
    cp = params_to_array(params, static)
    return (opts_to_c(opts), cp, forcing_to_array(forcing),
            state_to_array(state), np.zeros(cp.shape[0], FLUX_DTYPE))


def step_batch(co: COpts, cp: np.ndarray, cf: np.ndarray, cs: np.ndarray,
               cx: np.ndarray, dt: float):
    """``noahmp_step_batch`` over arrays of ``make_batch``: ``cs`` is
    advanced in place and ``cx`` written."""
    n = cp.shape[0]
    for arr, dtype in ((cp, PARAMS_DTYPE), (cf, FORCING_DTYPE),
                       (cs, STATE_DTYPE), (cx, FLUX_DTYPE)):
        if arr.dtype != dtype or arr.shape != (n,) or \
                not arr.flags.c_contiguous:
            raise ValueError(f"a batch array is {arr.dtype} {arr.shape}, "
                             f"needs a contiguous ({n},) {dtype}")
    load_batch().noahmp_step_batch(
        cp.ctypes.data_as(ct.POINTER(CColParams)), ct.byref(co),
        cf.ctypes.data_as(ct.POINTER(CForcing)), f(dt),
        cs.ctypes.data_as(ct.POINTER(CState)),
        cx.ctypes.data_as(ct.POINTER(CFlux)), n)


def bench_native(params, opts: Options, static: Static,
                 forcing: Forcing, state: State, steps: int = 10,
                 threads: int = 1) -> float:
    """Measure native column-steps/sec (state advances in place)."""
    co, cp, cf, cs, cx = make_batch(params, opts, static, forcing, state)
    n = len(cp)
    set_threads(threads)
    step_batch(co, cp, cf, cs, cx, 900.0)
    t0 = time.perf_counter()
    for _ in range(steps):
        step_batch(co, cp, cf, cs, cx, 900.0)
    dt = time.perf_counter() - t0
    return n * steps / dt
