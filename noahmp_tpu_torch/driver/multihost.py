"""Multi-process launcher of the port's offline driver; counterpart of
``examples/multihost.py``.

One process a device: ``torch.distributed`` joins them and the
land-point axis is spread over every rank (``dist/mesh.py``: each rank a
contiguous block, the tables replicated, no communication but strict
mode's flag).  Run it under ``torchrun``, or with the environment it
sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``)::

    torchrun --nproc-per-node 4 -m noahmp_tpu_torch.driver.multihost \\
        case.nml

    # two ranks on the CPU
    torchrun --nproc-per-node 2 -m noahmp_tpu_torch.driver.multihost \\
        case.nml --backend gloo --device cpu

Two ranks on one card need ``--backend gloo``: NCCL refuses them.
Without ``torchrun`` (one process) the mesh has one rank.  A synthetic
domain (``--points``, no domain file) is padded to a multiple of the
ranks.  Rank 0 prints; after the run every rank meets at a barrier and
rank 0 merges the ``.pLO-HI`` shard files of the ldasout and restart
directories into gridded files.

With ``--check-budgets strict`` a budget violation on any rank stops
every rank after the same step: each rank prints that step, writes the
State it stopped at as ``<restart_directory>/abort_<stamp>.nc`` shards,
rank 0 merges them, and the launcher exits with code 1.
"""

import argparse
import json
import os
import sys

import torch.distributed as dist

from ..dist.mesh import (DEFAULT_TIMEOUT, init_distributed, make_mesh,
                         process_slice)
from ..utils import ConservationError
from . import io as io_mod
from .config import Config
from .run import run_offline


def _budgets(v):
    return v if v == "strict" else int(v)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Noah-MP offline driver over torch.distributed ranks "
                    "(PyTorch/CUDA port)")
    ap.add_argument("namelist", help="configuration namelist file")
    ap.add_argument("--points", type=int, default=None,
                    help="synthetic domain size when no domain file "
                         "(default 64 a rank)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process group backend (default: NCCL where CUDA "
                         "is available, else gloo)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where every rank runs (default: the card; "
                         "raises without CUDA)")
    ap.add_argument("--check-budgets", type=_budgets, default=0,
                    metavar="N|strict",
                    help="as driver.cli; 'strict' stops every rank at the "
                         "first violating step anywhere")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT,
                    help="seconds a collective waits for a lost peer")
    args = ap.parse_args(argv)

    init_distributed(backend=args.backend, timeout=args.timeout)
    mesh = make_mesh(args.device, timeout=args.timeout)
    rank, world = mesh.get_local_rank(), mesh.size()
    if rank == 0:
        print(f"mesh: {world} ranks on {mesh.device_type}, backend "
              f"{dist.get_backend()}", flush=True)

    cfg = Config.from_namelist(args.namelist)
    n_points = args.points or 64 * world
    n_points += (-n_points) % world
    code = 0
    try:
        _state, files = run_offline(cfg, mesh=mesh, n_points=n_points,
                                    verbose=rank == 0,
                                    check_budgets_every=args.check_budgets)
    except ConservationError as err:
        if not hasattr(err, "state"):
            raise
        n = err.state.tg.shape[0] * world
        stamp = err.when.strftime("%Y%m%d%H%M")
        io_mod.save_restart_shard(
            os.path.join(cfg.resdir, f"abort_{stamp}.nc"), err.state,
            err.when, (*process_slice(mesh, n), n))
        print(json.dumps({"rank": rank, "abort_step": err.step,
                          "abort_time": err.when.isoformat(),
                          "error": str(err)}), flush=True)
        files, code = [], 1
    dist.barrier()
    if rank == 0:
        merged = (io_mod.merge_shard_files(cfg.outdir)
                  + io_mod.merge_shard_files(cfg.resdir))
        print(f"wrote {len(files)} output files a rank; merged "
              f"{len(merged)} files", flush=True)
    dist.destroy_process_group()
    return code


if __name__ == "__main__":
    sys.exit(main())
