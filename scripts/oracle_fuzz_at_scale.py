"""The JAX package's step against the serial C++ reference column on the
resync fuzz of ``chip_smoke.py``'s ``native_oracle`` phase, at its size:
the ten columns of ``tests/test_golden_native.py`` repeated (4,096
times each by default) under per-point weather from the phase's seed,
each step taken by the oracle (``noahmp_tpu_torch.native``, the same
library as the JAX binding's: equal structs, sources and flags,
``tests/test_torch_native.py``) from the State the JAX step started
from.  One JSON line an option set: the point-steps beyond
``FUZZ_TIGHT``, those beyond ``FUZZ_CAP`` or whose ``nsnow`` changed
(crossings), by step, with their points and land-use classes.

The JAX test's ``FUZZ_CAP`` allows no crossing over its 750 column-steps
a set; at 40,960 columns the reference crosses it too.
``crossings_by_step`` of each set is ``chip_smoke.py``'s
``JAX_FUZZ_CROSSINGS``: a set of the card's may cross no more often over
its steps than the reference did over the same steps.  It imports both
packages, as the tests do, and runs on the CPU (about 12 minutes on 8
cores)::

    JAX_PLATFORMS=cpu python scripts/oracle_fuzz_at_scale.py \\
        [--copies 4096] [--steps 24] [--sets default,dynveg2]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from noahmp_tpu import state as jax_state  # noqa: E402
from noahmp_tpu.driver.step import make_step  # noqa: E402
from noahmp_tpu.options import Options as JaxOptions  # noqa: E402
from noahmp_tpu.params import load_params as jax_load_params  # noqa: E402
from noahmp_tpu_torch import load_params, native  # noqa: E402
from noahmp_tpu_torch.cases import (FUZZ_COMBOS, FUZZ_TIGHT,  # noqa: E402
                                    fuzz_case, fuzz_forcing, fuzz_shares)

DT = 900.0
SEED = 42


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--copies", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--sets", default=",".join(n for n, _ in FUZZ_COMBOS))
    args = ap.parse_args(argv)
    native.BUILD_DIR = tempfile.mkdtemp(prefix="noahmp_oracle_")
    try:
        run(args)
    finally:
        shutil.rmtree(native.BUILD_DIR, ignore_errors=True)


def run(args):
    native.set_threads(os.cpu_count())
    params, jax_params = load_params(device="cpu"), jax_load_params()
    static_np, state_np = fuzz_case(args.copies)
    lutyp = static_np["lutyp"]
    n = lutyp.shape[0]
    static = jax_state.Static(**static_np)
    cp = native.params_to_array(params, static)
    for name, opts in FUZZ_COMBOS:
        if name not in args.sets.split(","):
            continue
        step = make_step(jax_params, JaxOptions(**opts._asdict()), DT,
                         donate=False)
        co = native.opts_to_c(opts)
        rng = np.random.default_rng(SEED)
        state = jax_state.State(**state_np)
        outliers, crossed = 0, []
        for k in range(args.steps):
            forcing = jax_state.Forcing(**fuzz_forcing(rng, n))
            cs = native.state_to_array(state)
            native.step_batch(co, cp, native.forcing_to_array(forcing), cs,
                              np.zeros(n, native.FLUX_DTYPE), DT)
            state, _flux = step(static, forcing, state)
            got = {f: np.asarray(getattr(state, f))
                   for f in list(FUZZ_TIGHT) + ["nsnow"]}
            share, cap, nsnow, by_field = fuzz_shares(got, cs)
            outliers += int((share > 1.0).sum())
            crossed += [
                {"step": k, "point": int(p), "land_use": int(lutyp[p]),
                 "nsnow_changed": bool(nsnow[p]),
                 "share_of_tight": {f: round(float(v[p]), 3)
                                    for f, v in by_field.items()
                                    if v[p] > 1.0}}
                for p in np.flatnonzero(cap | nsnow)]
        print(json.dumps({
            "set": name, "points": n, "steps": args.steps,
            "point_steps": n * args.steps, "outliers": outliers,
            "outlier_share": outliers / (n * args.steps),
            "crossings": len(crossed),
            "crossings_by_step": [sum(c["step"] == k for c in crossed)
                                  for k in range(args.steps)],
            "nsnow_changed": sum(c["nsnow_changed"] for c in crossed),
            "crossing_land_use": sorted({c["land_use"] for c in crossed}),
            "crossed": crossed}), flush=True)


if __name__ == "__main__":
    main()
