"""Command-line entry point of the port's offline driver; counterpart
of ``noahmp_tpu/driver/cli.py``.

Usage: python -m noahmp_tpu_torch.driver.cli [case.nml] [--points N]
    [--check-budgets N|strict] [--dispatch auto|chunk|step]
    [--chunk-steps T] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given; without CUDA and
without ``--device cpu`` it raises.
"""

import argparse

from .config import Config
from .run import run_offline

DEFAULT_NAMELIST_FILE = "case.nml"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Noah-MP land surface model, PyTorch/CUDA port "
                    "(offline driver)")
    parser.add_argument("nmlfile", nargs="?", type=str,
                        default=DEFAULT_NAMELIST_FILE,
                        help="configuration namelist file")
    parser.add_argument("--points", type=int, default=None,
                        help="number of land points when no domain file "
                        "is present")

    def _budgets(v):
        return v if v == "strict" else int(v)
    parser.add_argument("--check-budgets", type=_budgets, default=0,
                        metavar="N|strict",
                        help="assert energy/water conservation every N "
                        "steps (0 = off); 'strict' reproduces the "
                        "reference's fatal per-step 0.01 W/m2 abort "
                        "(func:688-721), checked on the device every step")
    parser.add_argument("--dispatch", choices=("auto", "chunk", "step"),
                        default="auto",
                        help="chunk: one chunk call per output window "
                        "(default); step: chunks of one step")
    parser.add_argument("--chunk-steps", type=int, default=0,
                        metavar="T",
                        help="cap the chunk length at T steps (0 = no "
                        "cap beyond the stacked forcing's memory)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the model runs (default: the card; "
                        "raises without CUDA)")
    args = parser.parse_args(argv)

    cfg = Config.from_namelist(args.nmlfile)
    return run_offline(cfg, n_points=args.points,
                       check_budgets_every=args.check_budgets,
                       dispatch=args.dispatch, chunk_steps=args.chunk_steps,
                       device=args.device)


if __name__ == "__main__":
    main()
