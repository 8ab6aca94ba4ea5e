"""Per-point parameters, gathered once.

Counterpart of ``noahmp_tpu/params/gathered.py``.  The physics indexes
the lookup tables as ``table[lutyp]`` every step.  The class indices are
static per point, so the gathers can be done once per domain:
``gather_params`` returns every table field the physics indexes as a
per-point ``(n,)`` or ``(n, k)`` tensor, in the fixed order of
``GATHERED_FIELDS``.  That ordered set is the parameter input of the
fused column kernel (``csrc/column_args.cuh`` declares the same list).

``Gathered.as_params()`` presents the same tensors as a ``Params``-shaped
object whose ``table[index]`` returns the gathered value, so that the
plain step (``physics/sflx.py:step_columns``) runs on them unchanged.
"""

from __future__ import annotations

from collections import OrderedDict
from types import SimpleNamespace

from .tables import Params, SoilParams, VegParams

_VEG_SCALARS = ("isurban", "iswater", "isbarren", "isice", "isegblf")
VEG_BY_LUTYP = tuple(f for f in VegParams.FIELDS if f not in _VEG_SCALARS)
SOIL_BY_SLTYP = tuple(f for f in SoilParams.FIELDS
                      if f not in ("albsat", "albdry"))
SOIL_BY_ISC = ("albsat", "albdry")
GEN_BY_SLP = ("slope",)

# the kernel's parameter list, in order
GATHERED_FIELDS = VEG_BY_LUTYP + SOIL_BY_SLTYP + SOIL_BY_ISC + GEN_BY_SLP

# table scalars, uniform over the grid, that the kernel takes by value
CLASS_SCALARS = ("isurban", "iswater", "isbarren", "isice")
GEN_SCALARS = ("csoil", "zbot", "czil", "timean", "fsatmax", "mltfct",
               "z0sno", "ssi", "swemax", "alblake_vis", "alblake_nir",
               "omegas_vis", "omegas_nir", "betads", "betais", "emssoil",
               "emslake")


class _Pre:
    """An already-gathered value: ``pre[index]`` returns it whatever the
    index."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __getitem__(self, _idx):
        return self.v


class Gathered:
    """The gathered per-point tensors (``fields``, an OrderedDict in
    ``GATHERED_FIELDS`` order) beside the tables they came from."""

    def __init__(self, params: Params, fields: OrderedDict):
        self.params = params
        self.fields = fields

    def as_params(self):
        """A ``Params``-shaped view for the plain step: per-class fields
        answer any index with the gathered value, scalar fields pass
        through."""
        def view(table, names):
            ns = SimpleNamespace(**{name: getattr(table, name)
                                    for name in table.FIELDS})
            for name in names:
                setattr(ns, name, _Pre(self.fields[name]))
            return ns

        p = self.params
        return SimpleNamespace(
            veg=view(p.veg, VEG_BY_LUTYP),
            soil=view(p.soil, SOIL_BY_SLTYP + SOIL_BY_ISC),
            gen=view(p.gen, GEN_BY_SLP))

    def class_scalars(self):
        """The special land-use classes as Python ints (reads the
        tables: a host synchronisation, made when a step is built)."""
        return [int(getattr(self.params.veg, name)) for name in CLASS_SCALARS]

    def gen_scalars(self):
        """The general scalar parameters as Python floats, the three
        band pairs spelled out as ``_vis``/``_nir``."""
        gen = self.params.gen
        out = []
        for name in GEN_SCALARS:
            base, _, band = name.partition("_")
            if band in ("vis", "nir"):
                out.append(float(getattr(gen, base)[0 if band == "vis" else 1]))
            else:
                out.append(float(getattr(gen, name)))
        return out


def gather_params(params: Params, lutyp, sltyp, isc, slptyp) -> Gathered:
    """Gather every per-class table field at the points' class indices
    (int tensors of shape (n,) on the tables' device)."""
    lutyp, sltyp = lutyp.long(), sltyp.long()
    isc, slptyp = isc.long(), slptyp.long()
    fields = OrderedDict()
    for name in VEG_BY_LUTYP:
        fields[name] = getattr(params.veg, name)[lutyp].contiguous()
    for name in SOIL_BY_SLTYP:
        fields[name] = getattr(params.soil, name)[sltyp].contiguous()
    for name in SOIL_BY_ISC:
        fields[name] = getattr(params.soil, name)[isc].contiguous()
    for name in GEN_BY_SLP:
        fields[name] = getattr(params.gen, name)[slptyp].contiguous()
    return Gathered(params, fields)
