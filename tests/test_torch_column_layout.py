"""The fused column kernel's argument layout and sources, checked
without a CUDA compiler: ``csrc/column_args.cuh`` against the Python
field lists, the includes, and the float literals of the headers."""

import ctypes
import os
import re

import pytest
import torch

from noahmp_tpu_torch import Flux, Forcing, Options, State, Static
from noahmp_tpu_torch.kernels import column
from noahmp_tpu_torch.kernels._build import CSRC_DIR, EXTRA_FLAGS
from noahmp_tpu_torch.params.gathered import GATHERED_FIELDS

HEAD = column.header_layout()

_VECTORS = {"zsoil": 4, "snice": 3, "snliq": 3, "zsnso": 7, "ficeold": 3,
            "stc": 7, "swc": 4, "smc": 4, "rhol": 2, "rhos": 2, "taul": 2,
            "taus": 2, "lai12m": 12, "sai12m": 12, "eps": 5, "albsat": 2,
            "albdry": 2}
_INTS = {"lutyp", "sltyp", "slptyp", "isc", "ist", "ice", "nsnow", "nroot",
         "c3c4"}


@pytest.mark.parametrize("key, fields", [
    ("STATIC", Static._fields), ("FORCING", Forcing._fields),
    ("STATE", State._fields), ("FLUX", Flux._fields),
    ("PARAM", GATHERED_FIELDS)])
def test_header_lists_names_in_python_order(key, fields):
    assert tuple(n for n, _d, _w in HEAD[key]) == tuple(fields)
    for name, dtype, width in HEAD[key]:
        assert width == _VECTORS.get(name, 1), name
        want = torch.int32 if name in _INTS else torch.float32
        assert dtype == want, name


def test_header_counts():
    assert len(HEAD["STATE"]) == 36 and len(HEAD["FLUX"]) == 61
    assert len(HEAD["STATIC"]) == 12 and len(HEAD["FORCING"]) == 15
    assert HEAD["OPTION"] == Options._fields
    column.check_layout()
    args = column._args_type()
    n_in = sum(len(HEAD[k]) for k in ("STATIC", "FORCING", "STATE", "PARAM"))
    assert len(args().in_) == n_in
    assert len(args().out) == 36 + 61
    # passed by value as the kernel's one parameter: under 4 KB
    assert ctypes.sizeof(args) < 4096


def test_seam_list_matches_python_side():
    """The words that cross between the stages: the header's X-macro
    list against ``SEAM_FIELDS``, name by name and width by width."""
    assert tuple((n, w) for n, _d, w in HEAD["SEAM"]) == column.SEAM_FIELDS
    assert column.SEAM_WORDS == sum(w for _n, _d, w in HEAD["SEAM"]) == 87
    names = [n for n, _w in column.SEAM_FIELDS]
    assert len(set(names)) == len(names)
    ints = {n for n, d, _w in HEAD["SEAM"] if d == torch.int32}
    assert ints == {"g_imelt"}
    # no seam word shadows an argument leaf's name in the accessors
    leaves = {n for key in ("STATIC", "FORCING", "STATE", "FLUX", "PARAM")
              for n, _d, _w in HEAD[key]}
    assert not leaves & {"get_" + n for n in names}


def test_seam_mismatch_is_refused(monkeypatch):
    monkeypatch.setattr(column, "SEAM_FIELDS", column.SEAM_FIELDS[:-1])
    with pytest.raises(RuntimeError, match="NM_SEAM_FIELDS"):
        column.check_layout()


def test_launches_and_slabs():
    assert column.STAGES == ("prologue", "flux", "ground", "water")
    assert column.LAUNCHES_PER_STEP == 4
    slab = column.SLAB_POINTS
    assert column.device_launches(1) == column.device_launches(slab) == 4
    assert column.device_launches(slab + 1) == 8
    args = column._args_type()
    assert [f[0] for f in args._fields_][:5] == ["in_", "out", "scratch",
                                                  "slab", "n"]


def test_words_per_point():
    """What a point moves: 90 words of state, forcing and static in, 121
    out, beside the gathered parameters."""
    def words(key):
        return sum(w for _n, _d, w in HEAD[key])
    assert words("STATE") == 60 and words("FLUX") == 61
    assert words("STATIC") + words("FORCING") + words("STATE") == 90


def _sources():
    return sorted(f for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh", ".h", ".cpp")))


@pytest.mark.parametrize("fname", _sources())
def test_every_include_exists(fname):
    with open(os.path.join(CSRC_DIR, fname)) as fh:
        for inc in re.findall(r'#include "([^"]+)"', fh.read()):
            assert os.path.exists(os.path.join(CSRC_DIR, inc)), inc


def test_one_header_per_physics_module():
    for mod in ("atm", "phenology", "thermo", "radiation", "sfc", "flux",
                "soiltemp", "energy", "snow", "soilwater", "water", "sflx"):
        assert os.path.exists(os.path.join(CSRC_DIR, mod + ".cuh")), mod
    assert "--fmad=false" in EXTRA_FLAGS["column"]


def _strip_f32(line):
    """Drop the arguments of F32(...): constants folded in double on
    purpose and narrowed once."""
    out, depth, i = [], 0, 0
    while i < len(line):
        if depth == 0 and line.startswith("F32(", i):
            depth, i = 1, i + 4
            continue
        if depth:
            depth += {"(": 1, ")": -1}.get(line[i], 0)
        else:
            out.append(line[i])
        i += 1
    return "".join(out)


_DOUBLE_LITERAL = re.compile(
    r"(?<![\w.])(?:\d+\.\d*|\.\d+|\d+(?=[eE]))(?:[eE][+-]?\d+)?(?![\w.])")


@pytest.mark.parametrize("fname", [f for f in _sources()
                                   if f.endswith(".cuh")])
def test_no_double_literal_outside_smpfz(fname):
    """One bare 0.5 widens a whole expression to double.  Every float
    literal in the headers carries its f suffix, except inside F32(...)
    and inside smpfz_f64, the step's one float64 spot."""
    with open(os.path.join(CSRC_DIR, fname)) as fh:
        text = fh.read()
    text = re.sub(r"NM_INL float smpfz_f64\(.*?\n}\n", "", text, flags=re.S)
    bad = []
    for no, line in enumerate(text.splitlines(), 1):
        code = _strip_f32(line.split("//")[0])
        if code.lstrip().startswith("#"):
            continue
        if _DOUBLE_LITERAL.search(code):
            bad.append(f"{fname}:{no}: {line.strip()}")
    assert not bad, "\n".join(bad)


def test_literal_check_sees_a_bare_double():
    assert _DOUBLE_LITERAL.search("x = 0.5 * y;")
    assert _DOUBLE_LITERAL.search("x = 1e-6 * y;")
    assert not _DOUBLE_LITERAL.search("x = 0.5f * y[2] + 1.0e-6f;")
    assert not _DOUBLE_LITERAL.search(_strip_f32("x = F32(2.5 * 0.01) * y;"))
