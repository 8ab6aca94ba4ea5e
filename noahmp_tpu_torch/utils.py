"""Observability and debugging utilities; counterpart of
``noahmp_tpu/utils.py``.

The reference has no tracing, profiling or sanitizers; its failure model
is print-and-stop.  Here:

- ``check_budgets``: host-side assertion on the batched conservation
  residuals (the reference's abort thresholds, applied to a whole batch
  at once instead of killing it for one column).
- ``nan_report``: locate NaN/Inf leaves in a State, Flux or other
  container.
- ``profile_step``: wrap a block in a ``torch.profiler`` trace.
- ``StepTimer``: points/sec and step-time counters for host loops.

Everything here reads tensors back to the host, by design: none of it is
called from inside a step or a chunk.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import numpy as np
import torch

SW_TOL = 0.01     # W/m2 (reference abort threshold, func:691)
ENG_TOL = 0.05    # W/m2 (0.01 upstream; widened for f32 batch round-off)
WAT_TOL = 0.5     # mm/step


class ConservationError(AssertionError):
    pass


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def check_budgets(flux, sw_tol=SW_TOL, eng_tol=ENG_TOL,
                  wat_tol=WAT_TOL, ist=None):
    """Assert the conservation residuals of a batched Flux.  Raises
    ConservationError naming the worst column."""
    for name, tol in (("errsw", sw_tol), ("erreng", eng_tol),
                      ("errwat", wat_tol)):
        arr = np.abs(_host(getattr(flux, name)))
        if name == "errwat" and ist is not None:
            arr = np.where(_host(ist) == 1, arr, 0.0)
        worst = int(np.argmax(arr))
        if arr[worst] > tol:
            raise ConservationError(
                f"{name} = {arr[worst]:.4g} at column {worst} "
                f"(tolerance {tol})")


def _leaves(tree, path):
    """(path, leaf) of every tensor or array below ``tree``: NamedTuples
    by field, dicts by key, other sequences by position."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield path, tree
    elif hasattr(tree, "_fields"):
        kind = type(tree).__name__
        for name in tree._fields:
            yield from _leaves(getattr(tree, name),
                               f"{path + '.' if path else ''}{kind}.{name}")
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for k, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{k}]")


def nan_report(tree, prefix="") -> Dict[str, int]:
    """Return {leaf_path: bad_count} for non-finite entries; a leaf of a
    State is named ``State.tg``."""
    bad = {}
    for path, leaf in _leaves(tree, ""):
        arr = _host(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        n = int(np.size(arr) - np.isfinite(arr).sum())
        if n:
            bad[prefix + path] = n
    return bad


def assert_finite(tree, what="state"):
    bad = nan_report(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: {bad}")


@contextlib.contextmanager
def profile_step(logdir: str):
    """``torch.profiler`` trace around a block, host and (where there is
    one) card; written to ``logdir`` as a Chrome trace
    (``trace.json``, for chrome://tracing or Perfetto).  Yields the
    profiler, whose ``key_averages()`` the caller may read afterwards."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Step-time / points-per-second counter for host time loops.  It
    reads the host's clock: on the card a step only enqueues, so
    synchronise inside the block where the step's own time is wanted."""

    def __init__(self, n_points: int):
        self.n = n_points
        self.steps = 0
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        self.steps += 1

    @property
    def points_per_sec(self):
        return self.n * self.steps / max(self.elapsed, 1e-12)

    @property
    def ms_per_step(self):
        return self.elapsed / max(self.steps, 1) * 1e3

    def summary(self) -> str:
        return (f"{self.steps} steps, {self.ms_per_step:.2f} ms/step, "
                f"{self.points_per_sec:,.0f} point-steps/s")
