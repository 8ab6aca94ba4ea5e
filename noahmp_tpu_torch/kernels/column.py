"""Fused column step: the CUDA kernel's wrapper beside its plain
PyTorch version.

Replaces the TPU kernel ``noahmp_tpu/pallas/column.py:make_pallas_step``
(inner ``kernel``): the whole of ``step_columns`` for every land point in
one launch.  Inputs are the gathered per-point parameters
(``params/gathered.py``), ``Static``, ``Forcing`` and ``State``; outputs
are the new ``State`` (36 leaves) and every ``Flux`` leaf (61), float32
with ``nsnow`` int32, batch-major ``(n,)`` and ``(n, L)`` as everywhere
in the port.

Bound on an H100: bytes, on paper.  A step needs 1,104 bytes a point
(90 words of state, forcing and static in, 121 out, plus the 65 words of
parameters the default options use) against some 9,300 float32
operations, so the least time the card could take is the bytes'
(``chip_smoke.py`` works both out).  The kernel as written moves more:
it loads every gathered parameter of its point, whatever the options
(``csrc/column_io.cuh``).  What holds the
kernel far above that bound is neither: a point is a long dependent
scalar program, many of its operations ``expf``/``logf``/``powf``, whose
live values exceed a thread's registers, and at 65,536 points the card
holds under 500 threads an SM.  The design for now is the simplest right
one: one thread per point, every input loaded once and every output
stored once straight from and to the batch-major arrays (no transposes,
no padding, the grid masks ``i < n``), the layer vectors in fixed-size
local arrays, the two implicit solves through ``thomas_solve<7>`` and
``thomas_solve<4>`` of ``csrc/tridiag.cuh``; registers capped at 128 a
thread so that the whole grid is resident at once.

The argument order has one source of truth on each side: ``State``,
``Flux``, ``Forcing`` and ``Static`` ``._fields`` with
``GATHERED_FIELDS`` here, the X-macro lists of ``csrc/column_args.cuh``
there.  ``header_layout`` parses the header; the wrapper refuses to
launch if the two disagree.
"""

import ctypes
import functools
import os
import re
from typing import NamedTuple

import torch

from ..options import Options
from ..params.gathered import (CLASS_SCALARS, GATHERED_FIELDS, GEN_SCALARS,
                               Gathered)
from ..physics.sflx import step_columns
from ..state import Flux, Forcing, State, Static
from ._build import CSRC_DIR, load_library

_CTYPE = {"float": torch.float32, "int": torch.int32}
_FIELD_LISTS = ("STATIC", "FORCING", "STATE", "FLUX", "PARAM")
_NAME_LISTS = ("OPTION", "CLASS", "GEN")


@functools.lru_cache(maxsize=None)
def header_layout(path=None):
    """The lists of ``csrc/column_args.cuh``: for STATIC, FORCING, STATE,
    FLUX and PARAM a tuple of (name, dtype, width); for OPTION, CLASS
    and GEN a tuple of names."""
    path = path or os.path.join(CSRC_DIR, "column_args.cuh")
    with open(path) as fh:
        text = fh.read().replace("\\\n", " ")
    layout = {}
    for key in _FIELD_LISTS:
        m = re.search(rf"#define NM_{key}_FIELDS\(XS, XV\)(.*)", text)
        layout[key] = tuple(
            (name, _CTYPE[ctype], int(width) if width else 1)
            for _kind, name, ctype, width in re.findall(
                r"X([SV])\((\w+),\s*(\w+)(?:,\s*(\d+))?\)", m.group(1)))
    for key, macro in (("OPTION", "NM_OPTION_FIELDS"),
                       ("CLASS", "NM_CLASS_SCALARS"),
                       ("GEN", "NM_GEN_SCALARS")):
        m = re.search(rf"#define {macro}\(X\)(.*)", text)
        layout[key] = tuple(re.findall(r"X\((\w+)\)", m.group(1)))
    return layout


def python_layout():
    """The same lists as the Python side names them."""
    return {"STATIC": Static._fields, "FORCING": Forcing._fields,
            "STATE": State._fields, "FLUX": Flux._fields,
            "PARAM": GATHERED_FIELDS, "OPTION": Options._fields,
            "CLASS": CLASS_SCALARS, "GEN": GEN_SCALARS}


def check_layout():
    """Raise unless the header declares the Python side's names in the
    Python side's order."""
    head, py = header_layout(), python_layout()
    for key in _FIELD_LISTS:
        names = tuple(name for name, _dt, _w in head[key])
        if names != tuple(py[key]):
            raise RuntimeError(f"column_args.cuh: NM_{key}_FIELDS does not "
                               f"match the Python field list")
    for key in _NAME_LISTS:
        if head[key] != tuple(py[key]):
            raise RuntimeError(f"column_args.cuh: the {key} list does not "
                               f"match the Python field list")


class ColumnConsts(NamedTuple):
    """What the kernel takes by value: read from the tables once, when a
    step is built, so that a step itself never waits for the card."""
    dt: float
    opts: tuple
    cls: tuple
    gen: tuple


def column_plain(gathered: Gathered, opts: Options, static, forcing, state,
                 dt):
    """The plain version: ``step_columns`` on the gathered parameters.
    ``dt`` is a 0-d float32 tensor on the state's device."""
    return step_columns(gathered.as_params(), opts, static, forcing, state,
                        dt)


@functools.lru_cache(maxsize=None)
def _args_type():
    head = header_layout()
    n_in = sum(len(head[k]) for k in ("STATIC", "FORCING", "STATE", "PARAM"))
    n_out = len(head["STATE"]) + len(head["FLUX"])

    class ColumnArgs(ctypes.Structure):
        _fields_ = [("in_", ctypes.c_void_p * n_in),
                    ("out", ctypes.c_void_p * n_out),
                    ("n", ctypes.c_int64),
                    ("dt", ctypes.c_float),
                    ("opt", ctypes.c_int * len(head["OPTION"])),
                    ("cls", ctypes.c_int * len(head["CLASS"])),
                    ("gen", ctypes.c_float * len(head["GEN"]))]

    return ColumnArgs


def check_abi(lib, args_type):
    """Hold the library's counts and struct size against this side's."""
    counts = (ctypes.c_int * 8)()
    lib.noahmp_column_abi.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.noahmp_column_abi.restype = None
    lib.noahmp_column_abi(counts)
    head = header_layout()
    want = [len(args_type().in_), len(args_type().out), len(head["OPTION"]),
            len(head["CLASS"]), len(head["GEN"]), ctypes.sizeof(args_type)]
    if list(counts[:6]) != want:
        raise RuntimeError(f"column kernel ABI {list(counts[:6])} does not "
                           f"match the wrapper's {want}")
    return list(counts)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The built library's launch function, its ABI checked against
    this side's layout."""
    check_layout()
    lib = load_library("column")
    args_type = _args_type()
    check_abi(lib, args_type)
    fn = lib.noahmp_column_step
    fn.argtypes = [ctypes.POINTER(args_type), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_attributes():
    """Registers and local-memory bytes a thread of the built kernel."""
    lib = load_library("column")
    attrs = (ctypes.c_int * 3)()
    lib.noahmp_column_attributes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.noahmp_column_attributes.restype = ctypes.c_int
    err = lib.noahmp_column_attributes(attrs)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed, CUDA error {err}")
    return {"registers_per_thread": attrs[0],
            "local_bytes_per_thread": attrs[1],
            "max_threads_per_block": attrs[2]}


def _check_leaf(where, name, t, dtype, width, n, device, need_cuda=True):
    if need_cuda and not t.is_cuda:
        raise ValueError(f"column_cuda: {where}.{name} is on {t.device}, "
                         "needs a CUDA tensor")
    if t.device != device:
        raise ValueError(f"column_cuda: {where}.{name} is on {t.device}, "
                         f"the others on {device}")
    if t.dtype != dtype:
        raise TypeError(f"column_cuda: {where}.{name} is {t.dtype}, "
                        f"needs {dtype}")
    shape = (n,) if width == 1 else (n, width)
    if tuple(t.shape) != shape:
        raise ValueError(f"column_cuda: {where}.{name} has shape "
                         f"{tuple(t.shape)}, needs {shape}")
    if not t.is_contiguous():
        raise ValueError(f"column_cuda: {where}.{name} is not contiguous")


def _checked(key, tree, n, device, need_cuda):
    """The leaves of one container in the header's order, each checked
    against the header's dtype and width."""
    leaves = []
    for name, dtype, width in header_layout()[key]:
        t = tree[name]
        _check_leaf(key.lower(), name, t, dtype, width, n, device, need_cuda)
        leaves.append(t)
    return leaves


class ColumnPlan:
    """Everything about a fused step that does not change from step to
    step, prepared once when the step is built: the by-value constants,
    the Static and parameter tensors (checked, their pointers already in
    the argument struct), and the layout of the two output allocations.  A
    step then checks and points to Forcing and State only."""

    def __init__(self, gathered: Gathered, opts: Options, dt, static,
                 need_cuda=True):
        head = header_layout()
        self.gathered = gathered
        self.static = static
        self.consts = ColumnConsts(float(dt), tuple(int(v) for v in opts),
                                   tuple(gathered.class_scalars()),
                                   tuple(gathered.gen_scalars()))
        self.n = static.lat.shape[0]
        self.device = static.lat.device
        self.need_cuda = need_cuda
        fixed_s = _checked("STATIC", static._asdict(), self.n, self.device,
                           need_cuda)
        fixed_p = _checked("PARAM", gathered.fields, self.n, self.device,
                           need_cuda)
        self._keep = fixed_s + fixed_p      # the pointers below stay valid
        self._at_forcing = len(head["STATIC"])
        self._at_state = self._at_forcing + len(head["FORCING"])
        at_param = self._at_state + len(head["STATE"])
        args = _args_type()()
        for k, t in enumerate(fixed_s):
            args.in_[k] = t.data_ptr()
        for k, t in enumerate(fixed_p):
            args.in_[at_param + k] = t.data_ptr()
        args.n = self.n
        args.dt = self.consts.dt
        args.opt[:] = self.consts.opts
        args.cls[:] = self.consts.cls
        args.gen[:] = self.consts.gen
        self.args = args
        self._specs = head["STATE"] + head["FLUX"]
        self._sizes = [self.n * w for _n, _d, w in self._specs]
        self._num_state = len(head["STATE"])

    def outputs(self):
        """New State and Flux containers and the flat list of their
        leaves in the kernel's order.  The leaves of a container are
        views of one allocation, each a contiguous batch-major block;
        State and Flux have an allocation each, so keeping the State
        does not keep the step's Flux alive."""
        leaves = []
        for lo, hi in ((0, self._num_state),
                       (self._num_state, len(self._specs))):
            sizes = self._sizes[lo:hi]
            buf = torch.empty(sum(sizes), dtype=torch.float32,
                              device=self.device)
            for leaf, (_name, dtype, width) in zip(buf.split(sizes),
                                                   self._specs[lo:hi]):
                if dtype != torch.float32:
                    leaf = leaf.view(dtype)
                if width != 1:
                    leaf = leaf.view(self.n, width)
                leaves.append(leaf)
        return (State(*leaves[:self._num_state]),
                Flux(*leaves[self._num_state:]), leaves)

    def point_to(self, forcing, state, outputs):
        """Check this step's Forcing and State and write their pointers
        and the outputs' into the argument struct."""
        args = self.args
        k = self._at_forcing
        for key, tree in (("FORCING", forcing._asdict()),
                          ("STATE", state._asdict())):
            for t in _checked(key, tree, self.n, self.device,
                              self.need_cuda):
                args.in_[k] = t.data_ptr()
                k += 1
        for k, t in enumerate(outputs):
            args.out[k] = t.data_ptr()
        return args


def column_cuda(plan: ColumnPlan, forcing, state):
    """One model step of every point on the card with the hand-written
    kernel.  Takes contiguous CUDA tensors of the containers' dtypes and
    shapes and raises on anything else; launches on the current stream,
    does not synchronise.  Returns (State, Flux)."""
    new_state, flux, outputs = plan.outputs()
    args = plan.point_to(forcing, state, outputs)
    if plan.n == 0:
        return new_state, flux
    fn = _launcher()
    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ctypes.byref(args), stream)
    column_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"column_cuda: launch failed, CUDA error {err}")
    return new_state, flux


column_cuda.launches = 0
LAUNCHES_PER_STEP = 1


def reset_launches():
    column_cuda.launches = 0
