"""How the offline run's host time moves with the number of threads that
assemble its exact forcing (``noahmp_tpu_torch/driver/io.py``:
``POOL_SIZE``, the parts ``FileForcing.__call__`` splits a step into).

On a machine with the card:

    python3 scripts/forcing_pool_sweep.py [--points 131072] [--reps 3]
        [--sizes 4,3,2,1]

writes the CONUS case of ``conus131k-offline-2day`` (seed 0, two model
days, ``benchmarks_torch/configs/conus131k.json``), runs ``run_offline``
once to warm up, then once per size per repetition with the cell's
residual report, the sizes in turns (their order reversed every other
repetition), each under ``benchmarks_torch.measure.HostSplit``.  Prints
the card's ``nvidia-smi`` line and one JSON line per size: the median
ms a step and point-steps a second on the host clock, and the host's
parts in ms a step (medians).  Size 1 assembles on the prefetch thread
alone, as before the pool.  ``--device cpu`` runs it on the CPU, where
its times are the CPU's, not the card's.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from benchmarks_torch import measure  # noqa: E402
from noahmp_tpu_torch.driver import io as driver_io  # noqa: E402
from noahmp_tpu_torch.driver import run as driver_run  # noqa: E402

CONF = os.path.join(os.path.dirname(HERE), "benchmarks_torch", "configs",
                    "conus131k.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument("--hours", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sizes", default="4,3,2,1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with open(CONF) as fh:
        conf = json.load(fh)
    n = args.points or conf["points"]
    hours = args.hours or 24 * conf["days"]
    sizes = [int(s) for s in args.sizes.split(",")]
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("forcing_pool_sweep: no CUDA device")
        print(measure.nvidia_smi_line(), flush=True)
    runs = {s: [] for s in sizes}
    with tempfile.TemporaryDirectory(prefix="pool_sweep_") as tmp:
        case = measure.write_case(
            n, hours // 24 + 1, tmp, out_hours=min(conf["output_hours"],
                                                   hours),
            hours=hours, restart_hours=min(conf["restart_hours"], hours))
        driver_run.run_offline(measure.offline_cfg(case, "warmup"),
                               verbose=False, device=device)
        for rep in range(args.reps):
            for size in (sizes if rep % 2 == 0 else sizes[::-1]):
                driver_io.POOL_SIZE = size
                cfg = measure.offline_cfg(case, f"s{size}_{rep}")
                with measure.HostSplit() as split:
                    *_out, ms = measure.run_summarised(
                        cfg, device=device,
                        residual_limit=conf["residual_limit"])
                report = split.report(n, cfg.nsteps)
                report["loop_ms_per_step"] = ms
                runs[size].append(report)
    for size in sizes:
        r = runs[size]
        print(json.dumps({
            "pool_size": size, "points": n, "steps": cfg.nsteps,
            "reps": args.reps, "device": str(device),
            "ms_per_step": statistics.median(
                x["loop_ms_per_step"] for x in r),
            "ms_per_step_runs": [x["loop_ms_per_step"] for x in r],
            "point_steps_per_s": statistics.median(
                1000.0 * n / x["loop_ms_per_step"] for x in r),
            "h2d_bytes_per_step": r[0]["h2d_bytes_per_step"],
            "host_ms_per_step": {
                k: statistics.median(x["host_ms_per_step"][k] for x in r)
                for k in measure.HostSplit.PARTS}}), flush=True)


if __name__ == "__main__":
    main()
