#!/usr/bin/env python3
"""Trips of the canopy Newton loop, point by point, on the spin-up cell's
domain (``conus1m-spinup-60day``), counted on the port's plain step.

The plain step (``physics/flux.py:vege_flux``) runs all NITERC trips of
the canopy loop and freezes a point once it is done; the column kernels
break at the top of the first trip at which the point was already done
(``csrc/flux.cuh``).  So a point's trips in the kernels are 1 plus the
number of trips at which ``done_before`` was false.  ``counting_trips``
reads that off by wrapping ``flux._freeze`` on the loop's carry while it
is open; nothing in the package changes for it.

For each step asked for, the script prints the mean trips over the
points, the mean over warps of 32 of the warp's most (the points as
drawn, sorted by ``ist`` and ``lutyp``, and sorted by whether the point
has a canopy at this step), the share of points that run every trip,
the mean by class with and without a canopy, the share of points
without one at this step (the vegetated tile's diagnostics NaN), the
histogram, and the lane trips a point that candidate pass ends of the
kernels' canopy loop would cost (``lane_trips``)::

    python scripts/canopy_trips.py --points 8192 --steps 96,200,282

It starts from ``init_state`` on Jan 1 and advances with the plain step
through the cell's analytic forcing, on the CPU unless ``--device``
says otherwise.
"""

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks_torch.spinup import DT, device_forcing, domain  # noqa: E402
from noahmp_tpu_torch import Options, load_params, make_step  # noqa: E402
from noahmp_tpu_torch.physics import flux as flux_physics  # noqa: E402
from noahmp_tpu_torch.state import init_state  # noqa: E402

WARP = 32
NITERC = flux_physics.NITERC
# USGS classes without a canopy: urban, water, barren, tundra (herbaceous,
# wooded, mixed, bare ground), ice, playa, lava, white sand
NO_CANOPY = (1, 16, 19, 23, 24, 25, 26, 27)
CANDIDATE_ENDS = ((20,), (1, 20), (8, 20), (10, 20), (11, 20), (12, 20),
                  (8, 11, 20), (9, 12, 20))


@contextlib.contextmanager
def counting_trips():
    """While open, each call of the plain ``vege_flux`` appends to the
    yielded list its points' trips in the kernels (int32, on the step's
    device)."""
    calls = []
    freeze = flux_physics._freeze
    seen = [0]

    def counted(done, old, new):
        if isinstance(old, flux_physics._Canopy):
            # trips 1 .. NITERC - 1 of one vege_flux call
            if seen[0] % (NITERC - 1) == 0:
                calls.append(torch.ones(done.shape, dtype=torch.int32,
                                        device=done.device))
            seen[0] += 1
            calls[-1] += (~done).to(torch.int32)
        return freeze(done, old, new)

    flux_physics._freeze = counted
    try:
        yield calls
    finally:
        flux_physics._freeze = freeze


def step_trips(step, static, forcing, state):
    """One plain step: (new State, the points' canopy trips, which points
    had no canopy), the last two numpy.  A point without a canopy
    (elai + esai = 0) gets NaN vegetated-tile diagnostics."""
    with counting_trips() as calls:
        new_state, flux = step(static, forcing, state)
    assert len(calls) == 1, "one vege_flux call a step"
    return (new_state, calls[0].cpu().numpy(),
            torch.isnan(flux.t2mv).cpu().numpy())


def warp_max_mean(trips, order=None):
    """Mean over warps of WARP points of the warp's most trips."""
    t = trips if order is None else trips[order]
    pad = (-len(t)) % WARP
    t = np.concatenate([t, np.zeros(pad, t.dtype)]).reshape(-1, WARP)
    return float(t.max(axis=1).mean())


def lane_trips(trips, ends):
    """Lane trips a point of the canopy loop run in passes ending at
    ``ends``: each pass over the points that enter it, in the order of
    the points (the kernels' lists keep a warp's points together), WARP
    a warp, each warp as long as its slowest point in the pass."""
    total, start = 0, 0
    for end in ends:
        entering = trips[trips > start]
        in_pass = np.minimum(entering, end) - start
        pad = (-len(in_pass)) % WARP
        warps = np.concatenate([in_pass, np.zeros(pad, in_pass.dtype)])
        total += WARP * int(warps.reshape(-1, WARP).max(axis=1).sum())
        start = end
    return total / len(trips)


def histogram(trips):
    """{trips: points} over 1 .. NITERC, the empty bins left out."""
    counts = np.bincount(trips, minlength=NITERC + 1)
    return {int(k): int(v) for k, v in enumerate(counts) if v}


def summary(trips, ist, lutyp, bare):
    """The figures of one step's (or several steps' pooled) trips;
    ``bare``: the points without a canopy."""
    no_canopy = np.isin(lutyp, NO_CANOPY)
    order = np.lexsort((lutyp, ist))
    return {
        "points": int(len(trips)),
        "mean": float(trips.mean()),
        "warp_max_mean_as_drawn": warp_max_mean(trips),
        "warp_max_mean_sorted_by_ist_lutyp": warp_max_mean(trips, order),
        "warp_max_mean_sorted_by_canopy": warp_max_mean(
            trips, np.argsort(bare, kind="stable")),
        "share_without_canopy": float(bare.mean()),
        "share_at_every_trip": float((trips == NITERC).mean()),
        "mean_no_canopy": float(trips[no_canopy].mean()),
        "mean_vegetated": float(trips[~no_canopy].mean()),
        "share_of_vegetated_at_every_trip":
            float((trips[~no_canopy] == NITERC).mean()),
        "histogram": histogram(trips),
        "share_entering_pass": {
            str(ends): [float((trips > start).mean())
                        for start in (0,) + ends[:-1]]
            for ends in CANDIDATE_ENDS},
        "lane_trips_per_point": {str(ends): lane_trips(trips, ends)
                                 for ends in CANDIDATE_ENDS},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--steps", default="96,200,282",
                    help="comma-separated steps since Jan 1 00:00")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    steps = sorted({int(s) for s in args.steps.split(",")})
    device = torch.device(args.device)
    static = domain(args.points, args.seed, device)
    state = init_state(args.points, device=device)
    step = make_step(load_params(device=device), Options(), DT, device)
    ist = static.ist.cpu().numpy()
    lutyp = static.lutyp.cpu().numpy()
    for k in range(steps[-1] + 1):
        forcing = device_forcing(k * DT, static)
        if k in steps:
            state, trips, bare = step_trips(step, static, forcing, state)
            print(json.dumps({"step": k,
                              **summary(trips, ist, lutyp, bare)}),
                  flush=True)
        else:
            state, _flux = step(static, forcing, state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
