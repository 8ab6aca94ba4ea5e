"""Non-default option values of the port against the JAX package, one
step from the same state on the regime that reaches the branch: the
options of the energy (radiation, exchange coefficients, stomata, soil heat) side.  Helpers and bars are those of
``test_torch_step.py``.
"""

import pytest

from noahmp_tpu.options import Options as JOptions

from noahmp_tpu_torch import Options
from noahmp_tpu_torch.cases import hetero_case

from test_torch_step import (assert_residuals, assert_step_close, jax_step,
                             torch_step)

VARIANTS = [
    ("sfc", 2, "warm_day"), ("crs", 2, "hot_dry"), ("alb", 1, "cold_snow"),
    ("rad", 2, "warm_day"), ("rad", 3, "warm_day"), ("btr", 2, "hot_dry"),
    ("btr", 3, "hot_dry"), ("veg", 1, "warm_day"), ("veg", 3, "warm_day"),
    ("stc", 2, "cold_snow"), ("tbot", 1, "cold_snow"),
]


@pytest.mark.parametrize("name,value,regime", VARIANTS,
                         ids=[f"{n}{v}" for n, v, _ in VARIANTS])
def test_option_variant_matches_jax(name, value, regime):
    case = hetero_case(regime)
    ref = jax_step(case, JOptions(**{name: value}))
    got = torch_step(case, Options(**{name: value}))
    assert_step_close(ref, got)
    assert_residuals(case[0], got[1])
