"""Elastic training: checkpoint-coordinated restart and world-size-elastic
resume.

Counterpart of `dgvit_tpu/core/elastic.py`, over the port's
`core/checkpoint.py` (one `torch.save` file of the whole train state a
step):

  * `ElasticCheckpointer`: periodic full-train-state checkpoints with
    retention, written once for the group: every rank enters a barrier
    (so the replicated state is final everywhere), rank 0 writes and
    prunes, every rank leaves through a second barrier. `resume` reads
    the newest checkpoint on every rank. It is the `resume(state) ->
    (state, step)` / `maybe_save(step, state)` object that
    `train/train_offline.py` takes.
  * `run_elastic`: runs the training function and, on a designated
    failure (a device-side fault, `SimulatedFault` in tests), restores the
    newest checkpoint and restarts, up to `max_restarts`. The checkpoint
    holds the whole SACState (parameters, targets, the three Adam states,
    alpha, the counter, the generators), so with a step-keyed data stream
    the resumed run is bit-identical to one without the fault.
  * `reshard_state`: a checkpoint written under one world size restored
    under another: the state is on the rank's device and rank 0's copy
    goes to every rank (`parallel/shard.shard_sac_state`). Nothing in the
    checkpoint depends on the world size.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from dgvit_tpu_torch.core.checkpoint import (latest_checkpoint,
                                             prune_checkpoints,
                                             restore_train_state,
                                             save_train_state)

log = logging.getLogger("dgvit.elastic")


class SimulatedFault(RuntimeError):
    """Raised by fault-injection hooks in tests and chaos drills."""


def default_failure_types() -> Tuple[type, ...]:
    """The failures that warrant a checkpoint-resume restart:
    `SimulatedFault` and the error PyTorch raises for a device-side fault
    (`torch.AcceleratorError` where the installed version has it), never
    an ordinary ValueError or RuntimeError of the program."""
    types = [SimulatedFault]
    if hasattr(torch, "AcceleratorError"):
        types.append(torch.AcceleratorError)
    return tuple(types)


def _group_mesh():
    """The active mesh, else the default group's (None in one process)."""
    import torch.distributed as dist

    from dgvit_tpu_torch.core import mesh as meshes

    mesh = meshes.active_mesh()
    if mesh is None and dist.is_available() and dist.is_initialized():
        mesh = meshes.make_mesh(device="cpu" if dist.get_backend() == "gloo"
                                else None)
    return mesh


class ElasticCheckpointer:
    """Periodic coordinated checkpoints with retention, and resume.

    Group protocol: every rank calls `save` (or `maybe_save`) with the
    same step; all enter a barrier, rank 0 writes and prunes to the
    newest `keep`, all leave through a second barrier, so no rank reads
    or runs past a checkpoint another is still writing. In one process
    the barriers are skipped."""

    def __init__(self, directory: str, interval: int = 50, keep: int = 3):
        assert interval >= 1
        self.directory = str(directory)
        self.interval = interval
        self.keep = keep

    def _barrier(self) -> None:
        mesh = _group_mesh()
        if mesh is not None and mesh.data > 1:
            from dgvit_tpu_torch.core.mesh import MeshRuntime
            MeshRuntime(mesh).barrier()

    @staticmethod
    def _rank() -> int:
        mesh = _group_mesh()
        return 0 if mesh is None else mesh.rank

    def save(self, step: int, state: Any) -> str:
        """Every rank must call this (collective). Returns the path."""
        self._barrier()
        path = str(Path(self.directory).absolute() / f"step_{step}")
        if self._rank() == 0:
            path = save_train_state(self.directory, step, state)
            if self.keep:
                prune_checkpoints(self.directory, self.keep)
        self._barrier()
        return path

    def maybe_save(self, step: int, state: Any) -> Optional[str]:
        if step > 0 and step % self.interval == 0:
            return self.save(step, state)
        return None

    def resume(self, template: Any) -> Tuple[Any, int]:
        """(state, start_step): the newest checkpoint restored into
        `template` (a state built for the same config), or (template, 0)
        on a cold start."""
        path = latest_checkpoint(self.directory)
        if path is None:
            return template, 0
        step = int(Path(path).name.split("_")[1])
        return restore_train_state(path, template), step


def reshard_state(state: Any, runtime) -> Any:
    """A restored (or cold) SACState placed for `runtime`: it must live on
    the rank's device (restore into a template the rank's agent built),
    and rank 0's copy becomes every rank's, so a run checkpointed at one
    world size resumes at another."""
    from dgvit_tpu_torch.parallel.shard import shard_sac_state

    dev = next(state.actor.parameters()).device
    if dev.type != runtime.device.type or (
            dev.type == "cuda" and dev.index != runtime.device.index):
        raise ValueError(f"reshard_state: the state is on {dev}, the "
                         f"rank's device is {runtime.device}; restore it "
                         "into a template built there")
    return shard_sac_state(runtime, state)


def run_elastic(train_fn: Callable[[Any, int, ElasticCheckpointer], Any],
                template_fn: Callable[[], Any],
                checkpointer: ElasticCheckpointer,
                max_restarts: int = 3,
                failure_types: Optional[Sequence[type]] = None,
                backoff_s: float = 0.0) -> Any:
    """Supervised training with checkpoint-coordinated restarts.

    train_fn(state, start_step, checkpointer) runs the loop (calling
    checkpointer.maybe_save) and returns the final state. On a failure of
    a designated type the newest checkpoint is restored into a fresh
    `template_fn()` and the loop restarts; anything else propagates at
    once, and a designated failure past `max_restarts` is raised."""
    failure_types = tuple(failure_types or default_failure_types())
    restarts = 0
    while True:
        state, start = checkpointer.resume(template_fn())
        if start:
            log.warning("elastic resume from step %d (restart %d)",
                        start, restarts)
        try:
            return train_fn(state, start, checkpointer)
        except failure_types as e:
            restarts += 1
            if restarts > max_restarts:
                log.error("elastic: giving up after %d restarts",
                          max_restarts)
                raise
            log.warning("elastic: %s: %s - restarting (%d/%d)",
                        type(e).__name__, e, restarts, max_restarts)
            if backoff_s:
                time.sleep(backoff_s)
