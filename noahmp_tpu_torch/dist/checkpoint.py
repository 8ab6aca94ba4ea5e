"""Sharded checkpoint and restore of the prognostic state over
``torch.distributed.checkpoint`` (DCP); counterpart of
``noahmp_tpu/dist/checkpoint.py`` (orbax there).

The reference declares restart files but never implements them
(run/case.nml:4,10-11).  Every rank writes its own block of the State
into one checkpoint directory a step, and reads its own block back.

DCP treats a plain tensor as replicated: it keeps one copy, and on
restore every rank reads that one (rank 1 got rank 0's rows).  So each
leaf is saved as ``DTensor.from_local(leaf, mesh, [Shard(0)])`` and
restored into such a template: each rank gets its own rows back.

A save with ``wait=False`` is ``dcp.async_save``: it copies the State
(each leaf cloned on its device first) to the host, then writes on a
thread of DCP's own while the model runs on.
Its collectives run on a gloo group that the manager makes on every rank
when it is built, never on the group of the model's main loop.

DCP and orbax checkpoints are not readable across the two packages; the
restart files (``driver/io.py``: ``save_restart``, ``save_restart_shard``
and ``merge_shard_files``) are.
"""

from __future__ import annotations

import datetime
import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor, Shard

from ..state import State
from .mesh import DEFAULT_TIMEOUT

METADATA = ".metadata"


class CheckpointManager:
    """DCP checkpoints of a State under ``directory``, one subdirectory a
    step (the offline driver's step is model seconds since
    ``driver/config.py:_ANCHOR``).  A step counts once its ``.metadata``
    is written; after each save has finished everywhere, rank 0 removes
    the oldest steps beyond ``max_to_keep`` (``None``: keeps them all).

    ``mesh``: the points mesh the State is sharded over
    (``dist.mesh.make_mesh``).  Without it the leaves are saved as they
    are, which is right in one process only: with more than one rank it
    raises.  ``timeout``: seconds the manager's collectives wait for a
    lost peer."""

    def __init__(self, directory: str, max_to_keep: int = 5, mesh=None,
                 timeout=DEFAULT_TIMEOUT):
        if mesh is None and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise ValueError("CheckpointManager: a State over several ranks "
                             "needs the mesh (DCP keeps one copy of a "
                             "plain tensor)")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        self._group = (dist.new_group(backend="gloo",
                                      timeout=datetime.timedelta(
                                          seconds=timeout))
                       if dist.is_initialized() else None)
        self._pending = None
        # the group's first collective connects its ranks (seconds with
        # two gloo ranks on one host): here, not inside a save that the
        # model's loop waits for
        self._barrier()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _rank(self) -> int:
        return dist.get_rank(self._group) if self._group is not None else 0

    def _barrier(self):
        if self._group is not None:
            dist.barrier(group=self._group)

    def _state_dict(self, tree):
        if self.mesh is None:
            return dict(zip(tree._fields, tree))
        return {name: DTensor.from_local(leaf, self.mesh, [Shard(0)],
                                         run_check=False)
                for name, leaf in zip(tree._fields, tree)}

    def _finish(self):
        """Wait for the save in flight, then prune."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
            self._prune()

    def _prune(self):
        self._barrier()
        if self._rank() == 0 and self.max_to_keep is not None:
            steps = self.all_steps()
            for step in steps[:max(0, len(steps) - self.max_to_keep)]:
                shutil.rmtree(self._path(step), ignore_errors=True)

    def all_steps(self):
        """The complete steps, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, METADATA)):
                steps.append(int(name))
        return sorted(steps)

    def save(self, step: int, state: State, wait: bool = False):
        self._finish()
        path = self._path(step)
        if self._rank() == 0 and os.path.exists(path):
            shutil.rmtree(path)     # a step saved again starts empty
        self._barrier()
        # storage of its own for every leaf: DCP's staging fails on a view
        # that starts inside its storage (torch 2.13: "invalid python
        # storage"), and a rank's rows cut from the whole, or a leaf of
        # the fused step's State allocation, are such views
        state_dict = self._state_dict(type(state)(*[leaf.clone()
                                                    for leaf in state]))
        if wait:
            dcp.save(state_dict, checkpoint_id=path,
                     process_group=self._group)
            self._prune()
        else:
            self._pending = dcp.async_save(state_dict, checkpoint_id=path,
                                           process_group=self._group)

    def restore(self, step: Optional[int] = None,
                template: Optional[State] = None) -> State:
        """The State of ``step`` (the latest complete one by default).
        With ``template`` (this rank's State, any values) each rank gets
        its own rows on the template's device; without it every rank
        gets the whole State on the host."""
        self._finish()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        if template is None:
            meta = dcp.FileSystemReader(path).read_metadata()
            state_dict = {
                name: torch.empty(tuple(meta.state_dict_metadata[name].size),
                                  dtype=meta.state_dict_metadata[name]
                                  .properties.dtype)
                for name in State._fields}
            dcp.load(state_dict, checkpoint_id=path,
                     process_group=self._group)
            return State(**state_dict)
        state_dict = self._state_dict(
            type(template)(*[torch.empty_like(leaf) for leaf in template]))
        dcp.load(state_dict, checkpoint_id=path, process_group=self._group)
        return type(template)(*[
            state_dict[name].to_local() if self.mesh is not None
            else state_dict[name] for name in template._fields])

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self):
        self._finish()
        if self._group is not None:
            dist.destroy_process_group(self._group)
            self._group = None
