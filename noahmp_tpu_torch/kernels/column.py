"""Fused column step: the CUDA kernels' wrapper beside their plain
PyTorch version.

Replaces the TPU kernel ``noahmp_tpu/pallas/column.py:make_pallas_step``
(inner ``kernel``): the whole of ``step_columns`` for every land point,
enqueued by one C call.  Inputs are the gathered per-point parameters
(``params/gathered.py``), ``Static``, ``Forcing`` and ``State``; outputs
are the new ``State`` (36 leaves) and every ``Flux`` leaf (61), float32
with ``nsnow`` int32, batch-major ``(n,)`` and ``(n, L)`` as everywhere
in the port.

Bound on an H100: bytes, on paper.  A step needs 1,104 bytes a point
(90 words of state, forcing and static in, 121 out, plus the 65 words of
parameters the default options use) against some 9,300 float32
operations (``chip_smoke.py`` works both out).  What holds the step
above that bound is instruction issue and latency: many of those
operations are IEEE divisions and ``expf``/``logf``/``powf`` calls of
some tens of instructions each, a point is one long dependent scalar
chain, and one thread a point gives the card few warps at 65,536 points
(``chip_smoke.py`` prints ``issue_ms`` beside ``bound_ms``).

The design (``csrc/column.cu``): a step is four stages (``STAGES``),
each its own kernel with its own register budget; what crosses
from a stage to a later one goes through a scratch buffer laid out
``(words, slab)`` so that every access is coalesced (``SEAM_FIELDS``).
The flux stage runs the canopy Newton loop in two passes
(``CANOPY_PASS_ENDS``), one launch each: after the first trip every
point is listed on the card, those with a canopy apart from those
without, and the second pass runs the remaining trips over the list, so
that a warp of it holds one kind of point and takes one kind of branch.
The launcher walks the points in slabs of ``SLAB_POINTS``, every stage
on one slab before the next, so the scratch is allocated once, when the
step is built, and is bounded whatever n is.  Every physics function is
inlined into its stage, which keeps a stage's values in registers.  In
the flux stage the vegetated and the bare tile of a point run on
different warps.  Inputs are read where they are used and outputs stored where
they are final, straight from and to the batch-major arrays (no
transposes, no padding, the grid masks ``i < n``); the two implicit
solves go through ``thomas_solve<7>`` and ``thomas_solve<4>`` of
``csrc/tridiag.cuh``.  With ``opt_veg`` 2 or 5 the carbon pools
(``csrc/carbon.cuh``) run at the end of the water stage, which holds
their inputs in registers: a step stays four stages.

The wrapper makes one ``ctypes`` call a step.  ``ColumnPlan`` prepares
everything that does not change from step to step, and recognises the
State (and Forcing) it has already checked: the State a step is given is
nearly always the very object the last step returned, whose leaves the
plan itself laid out.  Anything else is checked leaf by leaf and raises
on a wrong device, dtype, shape or stride.  A sequence of steps hands
over one Forcing stacked ``(T, n)``, checked once; step ``t`` reads row
``t`` of it (``column_cuda(plan, forcings, state, t)``).

The argument order has one source of truth on each side: ``State``,
``Flux``, ``Forcing`` and ``Static`` ``._fields`` with
``GATHERED_FIELDS`` and ``SEAM_FIELDS`` here, the X-macro lists of
``csrc/column_args.cuh`` there.  ``header_layout`` parses the header; the
wrapper refuses to launch if the two disagree.
"""

import ctypes
import functools
import os
import re
from typing import NamedTuple

import numpy as np
import torch

from ..options import Options
from ..params.gathered import (CLASS_SCALARS, GATHERED_FIELDS, GEN_SCALARS,
                               Gathered)
from ..physics import flux as flux_physics
from ..physics.sflx import step_columns
from ..state import Flux, Forcing, State, Static
from ._build import CSRC_DIR, load_library

_CTYPE = {"float": torch.float32, "int": torch.int32}
_FIELD_LISTS = ("STATIC", "FORCING", "STATE", "FLUX", "PARAM")
_NAME_LISTS = ("OPTION", "CLASS", "GEN")

# The stages of a step, in order, and the points a slab holds: every
# stage runs on one slab before the next slab begins, so the scratch
# holds SLAB_POINTS points at most, whatever n is (452 bytes a point, 474
# MB at most).  Slabs small enough for the scratch to stay in the L2
# cache were measured and lost: at 1,048,576 points, slabs of 65,536
# took 2.88 ms a step against 2.12 ms in one pass (csrc/column.cu).
STAGES = ("prologue", "flux", "ground", "water")
SLAB_POINTS = 1048576
# The trip at which each pass of the canopy loop ends
# (csrc/flux.cuh:kCanopyPassEnd); the flux stage is one launch a pass.
CANOPY_PASS_ENDS = (1, 20)
KERNELS = ("prologue", "flux", "flux_rest", "ground", "water")
LAUNCHES_PER_STEP = len(KERNELS)    # of each slab

# What crosses from one stage to a later one through the scratch buffer,
# (name, words), in the order of NM_SEAM_FIELDS in csrc/column_args.cuh.
SEAM_FIELDS = (
    # prologue -> flux, ground, water
    ("ur", 1), ("thair", 1), ("eair", 1), ("rhoair", 1), ("gammav", 1),
    ("gammag", 1), ("laisun", 1), ("laisha", 1), ("zlvl", 1), ("zpd", 1),
    ("z0m", 1), ("z0mg", 1), ("emv", 1), ("emg", 1), ("stc_top", 1),
    ("df_top", 1), ("dz_top", 1), ("rsurf", 1), ("latheav", 1),
    ("latheag", 1), ("parsun", 1), ("parsha", 1), ("igs", 1), ("btran", 1),
    ("rhsur", 1), ("htop", 1), ("elai", 1), ("esai", 1), ("df", 7),
    ("hcpct", 7), ("btrani", 4),
    # flux, vegetated tile -> ground (which rewrites v_tv for water)
    ("v_tv", 1), ("v_tgv", 1), ("v_tah", 1), ("v_eah", 1), ("v_cmv", 1),
    ("v_chv", 1), ("v_psnsun", 1), ("v_psnsha", 1), ("v_rssun", 1),
    ("v_rssha", 1),
    # flux, bare tile -> ground, water
    ("b_tgb", 1), ("b_qsfc", 1), ("b_cmb", 1), ("b_q2b", 1),
    # ground -> water
    ("qvap", 1), ("qdew", 1), ("g_snowh", 1), ("g_snice", 3),
    ("g_snliq", 3), ("g_stc", 7), ("g_swc", 4), ("g_smc", 4),
    ("g_imelt", 3),
    # canopy loop, first pass -> second (csrc/flux.cuh:CanopyCarry); the
    # list of the points
    ("c_tv", 1), ("c_tah", 1), ("c_cm", 1), ("c_ch", 1), ("c_h", 1),
    ("c_hg", 1), ("c_mozg", 1), ("c_fhg", 1), ("c_liter", 1),
    ("c1_moz", 1), ("c1_mozsgn", 1), ("c1_fm", 1), ("c1_fh", 1),
    ("c1_fm2", 1), ("c1_fh2", 1), ("c1_fv", 1), ("c2_akms", 1),
    ("c2_akhs", 1), ("c2_rlmo", 1), ("c2_wstar2", 1), ("c2_ustar", 1),
    ("c_rssun", 1), ("c_rssha", 1), ("c_psnsun", 1), ("c_psnsha", 1),
    ("pending", 1))
SEAM_WORDS = sum(words for _name, words in SEAM_FIELDS)
# int32 words after a slab's seam words: how many points the list of the
# canopy loop's second pass holds at its front (with a canopy) and at its
# back (without one) (csrc/column_args.cuh:kPassCounters)
PASS_COUNTERS = 2


def scratch_words(slab):
    """Float32 words of the scratch buffer of a step over slabs of
    ``slab`` points."""
    return SEAM_WORDS * slab + PASS_COUNTERS


def device_launches(n):
    """Kernel launches that one step of n points enqueues."""
    return LAUNCHES_PER_STEP * max(1, -(-n // SLAB_POINTS))


@functools.lru_cache(maxsize=None)
def header_layout(path=None):
    """The lists of ``csrc/column_args.cuh``: for STATIC, FORCING, STATE,
    FLUX, PARAM and SEAM a tuple of (name, dtype, width); for OPTION,
    CLASS and GEN a tuple of names."""
    path = path or os.path.join(CSRC_DIR, "column_args.cuh")
    with open(path) as fh:
        text = fh.read().replace("\\\n", " ")
    layout = {}
    for key in _FIELD_LISTS + ("SEAM",):
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
    Python side's order, and the same seam."""
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
    if tuple((name, w) for name, _dt, w in head["SEAM"]) != SEAM_FIELDS:
        raise RuntimeError("column_args.cuh: NM_SEAM_FIELDS does not match "
                           "SEAM_FIELDS")


class ColumnConsts(NamedTuple):
    """What the kernel takes by value: read from the tables once, when a
    step is built, so that a step itself never waits for the card.
    ``chen97_fixed_carry`` is ``physics/flux.py:CHEN97_FIXED_CARRY`` as
    it stood then (the JAX package reads its switch when it traces)."""
    dt: float
    opts: tuple
    chen97_fixed_carry: int
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
                    ("scratch", ctypes.c_void_p),
                    ("slab", ctypes.c_int64),
                    ("n", ctypes.c_int64),
                    ("dt", ctypes.c_float),
                    ("opt", ctypes.c_int * len(head["OPTION"])),
                    ("chen97_fixed_carry", ctypes.c_int),
                    ("cls", ctypes.c_int * len(head["CLASS"])),
                    ("gen", ctypes.c_float * len(head["GEN"]))]

    return ColumnArgs


def check_abi(lib, args_type):
    """Hold the library's counts and struct size against this side's."""
    counts = (ctypes.c_int * 10)()
    lib.noahmp_column_abi.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.noahmp_column_abi.restype = None
    lib.noahmp_column_abi(counts)
    head = header_layout()
    want = [len(args_type().in_), len(args_type().out), len(head["OPTION"]),
            len(head["CLASS"]), len(head["GEN"]), ctypes.sizeof(args_type)]
    if (list(counts[:6]) != want or counts[8] != SEAM_WORDS
            or counts[9] != PASS_COUNTERS):
        raise RuntimeError(f"column kernel ABI {list(counts)} does not "
                           f"match the wrapper's {want}, {SEAM_WORDS} words "
                           f"of scratch a point and {PASS_COUNTERS} after")
    return list(counts)


@functools.lru_cache(maxsize=None)
def _library():
    """The built library, its ABI checked against this side's layout."""
    check_layout()
    lib = load_library("column")
    args_type = _args_type()
    counts = check_abi(lib, args_type)
    if counts[7] != LAUNCHES_PER_STEP:
        raise RuntimeError(f"column kernel: {counts[7]} launches a slab, "
                           f"the wrapper expects {LAUNCHES_PER_STEP}")
    lib.noahmp_column_step.argtypes = [ctypes.POINTER(args_type),
                                       ctypes.c_void_p]
    lib.noahmp_column_step.restype = ctypes.c_int
    lib.noahmp_column_stage.argtypes = [ctypes.POINTER(args_type),
                                        ctypes.c_int, ctypes.c_void_p]
    lib.noahmp_column_stage.restype = ctypes.c_int
    lib.noahmp_column_attributes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.noahmp_column_attributes.restype = ctypes.c_int
    return lib


def kernel_attributes():
    """For each kernel of a slab (``KERNELS``) and the stage it belongs
    to: registers and local-memory bytes a thread, and its launch
    shape."""
    attrs = (ctypes.c_int * (5 * len(KERNELS)))()
    err = _library().noahmp_column_attributes(attrs)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed, CUDA error {err}")
    return [{"kernel": kernel,
             "stage": "flux" if kernel.startswith("flux") else kernel,
             "registers_per_thread": attrs[5 * k],
             "local_bytes_per_thread": attrs[5 * k + 1],
             "threads_per_block": attrs[5 * k + 2],
             "min_blocks_per_sm": attrs[5 * k + 3],
             "threads_per_point": attrs[5 * k + 4]}
            for k, kernel in enumerate(KERNELS)]


def _check_leaf(where, name, t, dtype, width, n, device, need_cuda=True):
    if need_cuda and not t.is_cuda:
        raise ValueError(f"column_cuda: {where}.{name} is on {t.device}, "
                         "needs a CUDA tensor")
    if t.device != device:
        raise ValueError(f"column_cuda: {where}.{name} is on {t.device}, "
                         f"the step was built for {device}")
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


_DATA_PTR = torch.Tensor.data_ptr


class ColumnPlan:
    """Everything about a fused step that does not change from step to
    step, prepared once when the step is built: the by-value constants,
    the Static and parameter tensors (checked, their pointers already in
    the argument struct), the scratch buffer, and the layout of the two
    output allocations, from which a step's 97 output pointers follow by
    adding two base addresses.

    A step's Forcing and State are checked leaf by leaf unless the plan
    knows them: the very container object it checked, or made, last
    time, whose leaves still point where they did.  A NamedTuple cannot
    be given another leaf, so a container with a replaced leaf is
    another object and is checked in full.

    A chunk of steps hands over one Forcing whose leaves are stacked
    ``(T, n)``: the plan checks it once, keeps its base addresses, and
    points step ``t`` at row ``t`` of every leaf by adding an offset, so
    that a step inside a chunk checks no Forcing leaf at all."""

    def __init__(self, gathered: Gathered, opts: Options, dt, static,
                 need_cuda=True):
        head = header_layout()
        self.gathered = gathered
        self.static = static
        self.consts = ColumnConsts(float(dt), tuple(int(v) for v in opts),
                                   int(bool(flux_physics.CHEN97_FIXED_CARRY)),
                                   tuple(gathered.class_scalars()),
                                   tuple(gathered.gen_scalars()))
        self.n = static.lat.shape[0]
        self.device = static.lat.device
        self.need_cuda = need_cuda
        fixed_s = _checked("STATIC", static._asdict(), self.n, self.device,
                           need_cuda)
        fixed_p = _checked("PARAM", gathered.fields, self.n, self.device,
                           need_cuda)
        self.slab = max(1, min(self.n, SLAB_POINTS))
        self.scratch = torch.empty(scratch_words(self.slab),
                                   dtype=torch.float32, device=self.device)
        self._keep = fixed_s + fixed_p      # the pointers below stay valid
        at_forcing = len(head["STATIC"])
        at_state = at_forcing + len(head["FORCING"])
        at_param = at_state + len(head["STATE"])
        args_type = _args_type()
        args = args_type()
        for k, t in enumerate(fixed_s):
            args.in_[k] = t.data_ptr()
        for k, t in enumerate(fixed_p):
            args.in_[at_param + k] = t.data_ptr()
        args.scratch = self.scratch.data_ptr()
        args.slab = self.slab
        args.n = self.n
        args.dt = self.consts.dt
        args.opt[:] = self.consts.opts
        args.chen97_fixed_carry = self.consts.chen97_fixed_carry
        args.cls[:] = self.consts.cls
        args.gen[:] = self.consts.gen
        self.args = args
        # a step's pointers are written through these windows on the
        # struct: Forcing and State in, State and Flux out
        num_state = len(head["STATE"])
        self._in = {
            "FORCING": self._window(args_type.in_, at_forcing,
                                    len(head["FORCING"])),
            "STATE": self._window(args_type.in_, at_state, num_state)}
        self._out = self._window(args_type.out, 0,
                                 num_state + len(head["FLUX"]))
        self._known = {"FORCING": (None, None), "STATE": (None, None)}
        self._stacked = (None, None, None)  # Forcing, pointers, base array
        # the two output allocations, State then Flux: for each its
        # leaves' sizes in words, their byte offsets, and the leaves
        # that are no (n,) float32 block
        self._layout = []
        for container, specs in ((State, head["STATE"]),
                                 (Flux, head["FLUX"])):
            sizes = [self.n * w for _n, _d, w in specs]
            offsets = 4 * (np.cumsum([0] + sizes[:-1], dtype=np.int64))
            reshape = [(k, dtype, width)
                       for k, (_n, dtype, width) in enumerate(specs)
                       if dtype != torch.float32 or width != 1]
            self._layout.append((container, sizes, offsets, reshape))

    def _window(self, field, first, count):
        """The pointers field[first : first + count] of the argument
        struct as an int64 array that aliases them."""
        word = ctypes.sizeof(ctypes.c_void_p)
        at = ctypes.addressof(self.args) + field.offset + word * first
        return np.frombuffer((ctypes.c_char * (word * count)).from_address(at),
                             dtype=np.int64)

    def _point_in(self, key, tree):
        known, pointers = self._known[key]
        if tree is not known or tuple(map(_DATA_PTR, tree)) != pointers:
            leaves = _checked(key, tree._asdict(), self.n, self.device,
                              self.need_cuda)
            pointers = tuple(map(_DATA_PTR, leaves))
            self._known[key] = (tree, pointers)
        self._in[key][:] = pointers

    def _point_in_stacked(self, forcings, t):
        known, pointers, base = self._stacked
        if (forcings is not known
                or tuple(map(_DATA_PTR, forcings)) != pointers):
            steps = forcings[0].shape[0] if forcings[0].dim() == 2 else -1
            for name, dtype, _width in header_layout()["FORCING"]:
                leaf = getattr(forcings, name)
                if leaf.dim() != 2 or leaf.shape[0] != steps:
                    raise ValueError(
                        f"column_cuda: forcing.{name} has shape "
                        f"{tuple(leaf.shape)}, a stacked Forcing needs "
                        f"(T, {self.n}) with one T for every leaf")
                _check_leaf("forcing", name, leaf[0], dtype, 1, self.n,
                            self.device, self.need_cuda)
                if not leaf.is_contiguous():
                    raise ValueError(f"column_cuda: forcing.{name} is not "
                                     "contiguous")
            pointers = tuple(map(_DATA_PTR, forcings))
            base = np.array(pointers, dtype=np.int64)
            self._stacked = (forcings, pointers, base)
        if not 0 <= t < forcings[0].shape[0]:
            raise IndexError(f"column_cuda: step {t} of a stacked Forcing "
                             f"of {forcings[0].shape[0]} steps")
        np.add(base, 4 * self.n * t, out=self._in["FORCING"])

    def point_to(self, forcing, state, t=None):
        """Write this step's Forcing and State pointers into the argument
        struct, after checking every leaf of a container the plan does
        not know.  With ``t`` given, ``forcing`` is stacked ``(T, n)`` and
        the step reads row ``t``."""
        if t is None:
            self._point_in("FORCING", forcing)
        else:
            self._point_in_stacked(forcing, t)
        self._point_in("STATE", state)
        return self.args

    def outputs(self):
        """New State and Flux containers, their pointers written into
        the argument struct.  The leaves of a container are views of one
        allocation, each a contiguous batch-major block; State and Flux
        have an allocation each, so keeping the State does not keep the
        step's Flux alive.  The plan made this State, so the next step
        takes it without checking it again."""
        made, at = [], 0
        for container, sizes, offsets, reshape in self._layout:
            buf = torch.empty(sum(sizes), dtype=torch.float32,
                              device=self.device)
            np.add(offsets, buf.data_ptr(), out=self._out[at:at + len(sizes)])
            leaves = list(buf.split(sizes))
            for k, dtype, width in reshape:
                leaf = leaves[k]
                if dtype != torch.float32:
                    leaf = leaf.view(dtype)
                if width != 1:
                    leaf = leaf.view(self.n, width)
                leaves[k] = leaf
            made.append(container(*leaves))
            at += len(sizes)
        new_state, flux = made
        self._known["STATE"] = (new_state,
                                tuple(self._out[:len(new_state)].tolist()))
        return new_state, flux


def column_cuda(plan: ColumnPlan, forcing, state, t=None):
    """One model step of every point on the card with the hand-written
    kernels.  Takes contiguous CUDA tensors of the containers' dtypes and
    shapes and raises on anything else; enqueues the step's launches on
    the current stream with one C call, does not synchronise.  With ``t``
    given, ``forcing`` holds a sequence, every leaf stacked ``(T, n)``,
    and the step reads row ``t`` of it.  Returns (State, Flux).
    ``column_cuda.launches`` counts steps; ``device_launches(n)`` says
    how many kernel launches a step is."""
    args = plan.point_to(forcing, state, t)
    new_state, flux = plan.outputs()
    if plan.n == 0:
        return new_state, flux
    fn = _library().noahmp_column_step
    with torch.cuda.device(plan.device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    column_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"column_cuda: launch failed, CUDA error {err}")
    return new_state, flux


column_cuda.launches = 0


def launch_stage(plan: ColumnPlan, stage):
    """Enqueue one stage alone (the flux stage: both passes, after
    emptying the canopy loop's list) on the pointers of the plan's last
    step, for timing it.  The caller keeps that step's Forcing,
    State and outputs alive; never part of a step, and counted
    nowhere."""
    fn = _library().noahmp_column_stage
    with torch.cuda.device(plan.device):
        err = fn(ctypes.byref(plan.args), STAGES.index(stage),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"column stage {stage}: launch failed, CUDA "
                           f"error {err}")


def reset_launches():
    column_cuda.launches = 0
