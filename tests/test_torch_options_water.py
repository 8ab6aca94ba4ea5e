"""Non-default option values of the port against the JAX package, one
step from the same state on the regime that reaches the branch: the
options of the water (runoff, infiltration, freezing, precipitation phase) side.  Helpers and bars are those of
``test_torch_step.py``.
"""

import numpy as np
import pytest

from noahmp_tpu.options import Options as JOptions

from noahmp_tpu_torch import Options
from noahmp_tpu_torch.cases import hetero_case

from test_torch_step import (assert_residuals, assert_step_close, jax_step,
                             torch_step)

VARIANTS = [
    ("run", 2, "warm_day"), ("run", 3, "frozen_morning"),
    ("run", 4, "warm_day"), ("frz", 2, "frozen_morning"),
    ("inf", 2, "frozen_morning"), ("snf", 2, "cold_snow"),
    ("snf", 3, "cold_snow"),
]


@pytest.mark.parametrize("name,value,regime", VARIANTS,
                         ids=[f"{n}{v}" for n, v, _ in VARIANTS])
def test_option_variant_matches_jax(name, value, regime):
    case = hetero_case(regime)
    ref = jax_step(case, JOptions(**{name: value}))
    got = torch_step(case, Options(**{name: value}))
    assert_step_close(ref, got)
    assert_residuals(case[0], got[1])


@pytest.mark.parametrize("frzx_compat", [True, False])
def test_quirk_frzx_compat(frzx_compat):
    """FRZX feeds the Schaake infiltration (opt_run=3) over frozen soil;
    both table variants match the JAX package."""
    case = hetero_case("frozen_morning")
    case[2]["swc"][:] = 0.2            # soil ice: smc - swc = 0.1
    ref = jax_step(case, JOptions(run=3), frzx_compat=frzx_compat)
    got = torch_step(case, Options(run=3), frzx_compat=frzx_compat)
    assert_step_close(ref, got)


def test_quirk_frzx_changes_the_runoff():
    case = hetero_case("warm_day")
    case[2]["swc"][:] = 0.15
    a = torch_step(case, Options(run=3), frzx_compat=True)[1]["runsrf"]
    b = torch_step(case, Options(run=3), frzx_compat=False)[1]["runsrf"]
    assert np.any(a != b)
