"""``scripts/canopy_trips.py``: the canopy loop's trips counted on the
plain step, and the lane trips of a loop run in passes, on inputs whose
answers are known."""

import numpy as np
import pytest

from benchmarks_torch.spinup import DT, device_forcing, domain
from noahmp_tpu_torch import Options, load_params, make_step
from noahmp_tpu_torch.physics import flux as flux_physics
from noahmp_tpu_torch.state import init_state
from scripts import canopy_trips


def test_lane_trips_of_passes():
    """One warp of 32 points, 31 of them leaving after 6 trips and one
    after 20: one pass runs 20 trips a lane; a pass to trip 6 then one
    over the lone point (a warp of its own) runs 6 + 14."""
    trips = np.array([6] * 31 + [20], np.int32)
    assert canopy_trips.lane_trips(trips, (20,)) == 20
    assert canopy_trips.lane_trips(trips, (6, 20)) == 6 + 14
    assert canopy_trips.warp_max_mean(trips) == 20
    assert canopy_trips.histogram(trips) == {6: 31, 20: 1}


@pytest.mark.parametrize("k", [3, 40])
def test_trips_counted_on_the_plain_step(k):
    """On the spin-up cell's domain: every point runs 6 to 20 trips, those
    without a canopy all 20, and counting leaves ``_freeze`` and the
    step's results as they were."""
    n = 256
    static = domain(n, 0, "cpu")
    state = init_state(n, device="cpu")
    step = make_step(load_params(device="cpu"), Options(), DT, device="cpu")
    for j in range(k):
        state, _flux = step(static, device_forcing(j * DT, static), state)
    forcing = device_forcing(k * DT, static)
    freeze = flux_physics._freeze
    counted_state, trips, bare = canopy_trips.step_trips(step, static,
                                                         forcing, state)
    assert flux_physics._freeze is freeze
    plain_state, _flux = step(static, forcing, state)
    for a, b in zip(counted_state, plain_state):
        assert np.array_equal(a.numpy(), b.numpy(), equal_nan=True)
    assert trips.min() >= 6 and trips.max() <= flux_physics.NITERC
    assert bare.any() and (trips[bare] == flux_physics.NITERC).all()
    out = canopy_trips.summary(trips, static.ist.numpy(),
                               static.lutyp.numpy(), bare)
    assert out["share_without_canopy"] == pytest.approx(bare.mean())
    assert out["lane_trips_per_point"]["(20,)"] == 20
