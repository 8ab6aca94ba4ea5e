"""Carry parameters and state between numpy and the port's containers.

The tests feed these with the JAX package's numpy leaves (turned into
dicts with ``._asdict()``); a user feeds them with arrays read from a
file.  int32 stays int32: an index is widened with ``.long()`` at the
gather, never in the container.
"""

import numpy as np
import torch

from .device import resolve_device
from .params.tables import Params, VegParams, SoilParams, GenParams


def _leaf(v, device):
    a = np.asarray(v)
    if a.dtype not in (np.float32, np.int32):
        raise TypeError(f"leaf is {a.dtype}, needs float32 or int32")
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(veg: dict, soil: dict, gen: dict,
                      device=None) -> Params:
    """Build ``Params`` from three dicts of numpy leaves (the fields of
    VegParams, SoilParams and GenParams)."""
    device = resolve_device(device)
    return Params(VegParams(veg), SoilParams(soil), GenParams(gen)).to(device)


def tree_from_numpy(cls, leaves: dict, device=None):
    """``cls`` (State, Static, Forcing or Flux) from a dict of numpy
    arrays with the land-point axis first."""
    device = resolve_device(device)
    return cls(**{name: _leaf(leaves[name], device) for name in cls._fields})


def tree_on_device(cls, tree, device):
    """A container of tensors or numpy arrays as ``cls`` on ``device``,
    every leaf contiguous (what the fused step's plan requires); leaves
    already there and contiguous stay as they are."""
    leaves = []
    for name, leaf in zip(cls._fields, tree):
        if not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
            if leaf.dtype not in (np.float32, np.int32):
                raise TypeError(f"{cls.__name__}.{name} is {leaf.dtype}, "
                                "needs float32 or int32")
            # a C-ordered copy: a broadcast view (zsoil, a held forcing
            # field) copied in numpy's default order can come out
            # column-major
            leaf = torch.from_numpy(np.array(leaf, order="C"))
        leaves.append(leaf.to(device).contiguous())
    return cls(*leaves)


def tree_to_numpy(t) -> dict:
    """A container's leaves as numpy arrays on the host."""
    return {name: getattr(t, name).detach().cpu().numpy()
            for name in t._fields}
