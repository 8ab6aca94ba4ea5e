"""SPMD scale-out over the land-point axis; counterpart of
``noahmp_tpu/dist/mesh.py``.

The reference is serial (SURVEY.md section 2.6); the one first-class
parallel dimension is land points, which are independent of each other.
The decomposition is the JAX package's: each rank holds one contiguous
block of the points, the parameter tables are replicated (every rank
loads them itself), and the only collectives are the diagnostics'
reductions (``make_sharded_step``) and strict mode's per-step flag
(``driver/step.py:make_chunk_step``).

In PyTorch's idiom each process drives one device.  Rank ``r`` of ``w``
owns rows ``[r*n/w, (r+1)*n/w)`` of every State, Static and Forcing leaf
and holds them as plain local tensors on its own device:
``cuda:LOCAL_RANK`` (modulo the cards the process sees, so that several
ranks may share one card), or the CPU when asked for.  There is no
global array, so placing data needs no communication: ``shard_batch``
slices, ``replicate`` moves.  The JAX package's ``batch_sharding``,
``replicated`` and ``put_global`` therefore have no counterpart.  Never
compare the tables across ranks with ``==``: the "unset" sentinels are
NaN (module_noahmp_const.f90:12-13) and fail it.

Threads: no collective runs on the offline driver's prefetch or sink
threads.  Gloo dies when two processes interleave collectives in a
different order, which the JAX package saw when hidden placement
collectives ran on those threads.
"""

import datetime
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..convert import tree_on_device
from ..driver.step import make_fused_step, make_step

POINTS_AXIS = "points"
DEFAULT_TIMEOUT = 600.0   # seconds a collective waits for a lost peer


def _timeout(seconds):
    return datetime.timedelta(seconds=float(seconds))


def local_cuda_index(rank=None):
    """The card this process drives: ``LOCAL_RANK`` (else the global
    rank) modulo the cards it sees."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None,
                     timeout=DEFAULT_TIMEOUT):
    """Join the job's process group; a no-op for one process, as in the
    JAX package.  Returns whether a group was made.

    ``num_processes`` ``None`` reads ``WORLD_SIZE`` (``torchrun`` sets
    it; 1 when unset).  With ``coordinator_address`` ("host:port" of
    rank 0) the group meets there, ``process_id`` being this rank;
    without it ``env://`` reads ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``.  ``backend`` ``None`` is NCCL
    where CUDA is available and gloo where it is not; ``"gloo"`` can be
    asked for on cards (two ranks on one card need it: NCCL refuses
    them).  Every collective of the group fails after ``timeout``
    seconds without its peers instead of hanging."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if process_id is None else process_id
    else:
        if process_id is None:
            raise ValueError("coordinator_address needs process_id")
        init_method = f"tcp://{coordinator_address}"
        rank = process_id
    if backend == "nccl":
        # NCCL binds its communicator to the current card
        torch.cuda.set_device(local_cuda_index(rank))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=rank,
                            timeout=_timeout(timeout))
    return True


def make_mesh(device_type=None, timeout=DEFAULT_TIMEOUT):
    """A 1-D ``DeviceMesh`` over every rank of the job, its one dimension
    named ``POINTS_AXIS``.

    ``device_type`` ``None`` means CUDA and raises when CUDA is not
    available (``device.resolve_device``'s rule); ``"cpu"`` asks for the
    CPU and needs a gloo group.  In one process with no group yet, the
    mesh spans that process alone, as the JAX mesh spans the local
    devices: a one-rank group (NCCL for CUDA, gloo for the CPU) is made
    over an in-process store, so that no port is opened."""
    if device_type is None:
        device_type = "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' "
                           "to run the mesh on the host")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: cuda or cpu")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0,
                                timeout=_timeout(timeout))
    if device_type == "cpu" and "gloo" not in dist.get_backend():
        raise ValueError(f"a CPU mesh needs gloo; the group runs "
                         f"{dist.get_backend()}")
    if device_type == "cuda":
        torch.cuda.set_device(local_cuda_index())
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(POINTS_AXIS,))


def mesh_device(mesh):
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def rank_device(mesh, device=None):
    """This rank's device on ``mesh``; raises ValueError when ``device``
    (if given) names another."""
    on_mesh = mesh_device(mesh)
    asked = torch.device(device if device is not None else on_mesh)
    if asked.type != on_mesh.type or asked.index not in (None,
                                                         on_mesh.index):
        raise ValueError(f"device {device} is not this rank's device "
                         f"{on_mesh} on the mesh")
    return on_mesh


def mesh_group(mesh):
    """The process group of the points axis."""
    return mesh.get_group(POINTS_AXIS)


def process_slice(mesh, n: int):
    """Global row range [lo, hi) of the land-point axis that this rank
    owns: equal blocks in rank order.  Raises ValueError unless the
    ranks divide ``n``."""
    world = mesh.size()
    if n % world:
        raise ValueError(f"n={n} not divisible by {world} ranks")
    per = n // world
    rank = mesh.get_local_rank(POINTS_AXIS)
    return rank * per, (rank + 1) * per


def shard_batch(tree, mesh):
    """This rank's rows of every leaf of a container of host or device
    leaves (the land-point axis leading, every leaf of one length), as
    the same container on this rank's device; no communication."""
    sizes = {int(np.shape(leaf)[0]) for leaf in tree}
    if len(sizes) != 1:
        raise ValueError(f"{type(tree).__name__}: leaves of lengths "
                         f"{sorted(sizes)}, needs one")
    lo, hi = process_slice(mesh, sizes.pop())
    return tree_on_device(type(tree), [leaf[lo:hi] for leaf in tree],
                          mesh_device(mesh))


def replicate(tree, mesh):
    """The whole of ``tree`` on this rank's device: ``Params`` (moved in
    place, as ``make_step`` moves it) or a container of leaves."""
    device = mesh_device(mesh)
    if isinstance(tree, torch.nn.Module):
        return tree.to(device)
    return tree_on_device(type(tree), tree, device)


class StepDiagnostics(NamedTuple):
    """Conservation diagnostics reduced over every rank (0-d tensors on
    this rank's device; the only communication of a step)."""
    max_abs_errsw: torch.Tensor
    max_abs_erreng: torch.Tensor
    max_abs_errwat: torch.Tensor
    mean_fsh: torch.Tensor
    mean_fsa: torch.Tensor


def make_sharded_step(params, opts, dt, mesh, with_diagnostics=True,
                      static=None):
    """Build step(static, forcing, state) -> (state, flux, diagnostics)
    for this rank's block of points.

    With ``static`` (this rank's Static) the step is the fused one for
    that block (``column_cuda`` on the card) and ignores its first
    argument; without it, the eager step.  ``diagnostics`` is a
    ``StepDiagnostics`` over every rank (``None`` without
    ``with_diagnostics``): one ``all_reduce(MAX)`` of the three absmax
    residuals and one ``all_reduce(SUM)`` of the local float64 sums of
    ``fsh`` and ``fsa``, divided by the global number of points.  The
    JAX package's ``donate`` is not taken, as for ``make_step``."""
    device = mesh_device(mesh)
    group = mesh_group(mesh)
    world = mesh.size()
    if static is None:
        single = make_step(params, opts, dt, device=device)
    else:
        single = make_fused_step(params, opts, dt, static, device=device)

    def step(static_now, forcing, state):
        new_state, flux = single(static_now, forcing, state)
        if not with_diagnostics:
            return new_state, flux, None
        with torch.no_grad():
            peaks = torch.stack([flux.errsw.abs().max(),
                                 flux.erreng.abs().max(),
                                 flux.errwat.abs().max()])
            sums = torch.stack([flux.fsh.double().sum(),
                                flux.fsa.double().sum()])
            dist.all_reduce(peaks, op=dist.ReduceOp.MAX, group=group)
            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
            means = (sums / (flux.fsh.shape[0] * world)).float()
        return new_state, flux, StepDiagnostics(*peaks, *means)

    step.params = single.params
    step.device = device
    return step
