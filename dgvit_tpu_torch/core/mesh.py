"""Mesh / runtime layer over torch.distributed.

Counterpart of `dgvit_tpu/core/mesh.py`, with its axis names:

  data  - batch sharding of the SAC train step: the process group, one
          rank per device (gradients averaged across it inside the step)
  model - tensor parallelism: not ported (raises by name)
  seq   - the token stream's sharding (ring attention): not ported

The JAX package lays the axes over the devices one process drives; here
`data` is the process group's world size (`core/distributed.py` joins
it). `make_mesh(data=-1)` absorbs the world, any other `data` must equal
it. Every rank holds the whole train state: `replicate` broadcasts rank
0's tensors, `shard_batch` takes a global batch and returns the rank's
rows (rank-major, as `distributed.local_batch_slice`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model, seq) layout over a process group: `rank` of
    `data` ranks in `group` (None: the default group, or no group in a
    single process), each on `device`."""

    data: int
    model: int
    seq: int
    rank: int
    group: Optional[Any]
    device: torch.device

    @property
    def shape(self):
        return {AXIS_DATA: self.data, AXIS_MODEL: self.model,
                AXIS_SEQ: self.seq}


# ---------------------------------------------------------------------------
# Active-mesh registry: the agent's data-axis update (`agents/sac.py`,
# grad_axis='data') looks its group up here. Set by use_mesh (which
# parallel.shardmap_learn enters around every step).
# ---------------------------------------------------------------------------
_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


class use_mesh:
    """Context manager: publish the mesh (a Mesh or a MeshRuntime) to the
    registry, restoring the previous one after."""

    def __init__(self, mesh):
        self.mesh = getattr(mesh, "mesh", mesh)

    def __enter__(self):
        self._prev = active_mesh()
        set_active_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_active_mesh(self._prev)
        return False


def _refuse(axis: str, size: int) -> None:
    if size != 1:
        raise NotImplementedError(
            f"mesh axis '{axis}' of size {size}: the port shards only the "
            "'data' axis (model and seq are not ported)")


def make_mesh(data: int = -1, model: int = 1, seq: int = 1,
              group: Optional[Any] = None,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The mesh over `group` (the default group; one rank without one).
    data=-1 absorbs the world size; any other data must equal it.
    device: the rank's (None: `distributed.rank_device()`)."""
    from dgvit_tpu_torch.core.distributed import rank_device

    _refuse(AXIS_MODEL, model)
    _refuse(AXIS_SEQ, seq)
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size(group) if joined else 1
    if data == -1:
        data = world
    if data != world:
        raise ValueError(
            f"mesh axis 'data' of size {data}: the process group has "
            f"{world} rank(s); data is the world size (or -1)")
    return Mesh(data=data, model=model, seq=seq,
                rank=dist.get_rank(group) if joined else 0,
                group=group if joined else None,
                device=rank_device(device))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor lives on the mesh: every rank's copy the same
    ('replicated', which `replicate` makes), or its leading dim split
    over an axis ('sharded', `shard_batch`)."""

    kind: str
    axis: Optional[str] = None


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@dataclasses.dataclass
class MeshRuntime:
    """The mesh plus its placements for the train step."""

    mesh: Mesh

    @classmethod
    def create(cls, data: int = -1, model: int = 1, seq: int = 1,
               group: Optional[Any] = None,
               device: Optional[Union[str, torch.device]] = None
               ) -> "MeshRuntime":
        return cls(mesh=make_mesh(data, model, seq, group, device))

    @property
    def world(self) -> int:
        return self.mesh.data

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def group(self):
        return self.mesh.group

    # ---- placements -------------------------------------------------------
    def replicated(self) -> Placement:
        return Placement("replicated")

    def rows(self, n: int) -> slice:
        """This rank's rows of `n` global rows (rank-major)."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split over data "
                             f"{self.world}")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_batch(self, tree):
        """The rank's rows of each batch array in `tree` (the global
        batch), on the rank's device; numpy arrays stay numpy."""
        if isinstance(tree, dict):
            return {k: self.shard_batch(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.shard_batch(v) for v in tree)
        if isinstance(tree, torch.Tensor):
            return tree[self.rows(tree.shape[0])].to(self.device)
        if hasattr(tree, "shape") and len(tree.shape):
            return tree[self.rows(tree.shape[0])]
        return tree

    def comm(self, t: torch.Tensor) -> torch.Tensor:
        """`t` on a device the group's backend takes (NCCL: the rank's
        card; gloo: where it is)."""
        if self.group is None and not dist.is_initialized():
            return t
        if dist.get_backend(self.group) == "nccl" and not t.is_cuda:
            return t.to(self.device)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s value of `t` into `t` on every rank, in place."""
        if self.world == 1:
            return t
        c = self.comm(t.detach())
        dist.broadcast(c, src=dist.get_global_rank(self.group, src)
                       if self.group is not None else src,
                       group=self.group)
        if c is not t:
            with torch.no_grad():
                t.copy_(c)
        return t

    def replicate(self, tree):
        """Every tensor of `tree` (a tensor, a module, or dicts, lists and
        tuples of them) made rank 0's, in place; returns `tree`."""
        for t in _tensors(tree):
            self.broadcast_(t.data if isinstance(t, torch.nn.Parameter)
                            else t)
        return tree

    def broadcast_object(self, obj, src: int = 0):
        """Rank `src`'s picklable `obj` on every rank."""
        if self.world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self.group, src)
            if self.group is not None else src, group=self.group,
            device=self.device if dist.get_backend(self.group) == "nccl"
            else None)
        return box[0]

    def barrier(self) -> None:
        if self.world > 1:
            if dist.get_backend(self.group) == "nccl":
                dist.barrier(group=self.group,
                             device_ids=[self.device.index])
            else:
                dist.barrier(group=self.group)
