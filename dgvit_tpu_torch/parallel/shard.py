"""Sharded training: data parallelism over the `data` mesh axis.

Counterpart of `dgvit_tpu/parallel/shard.py`. The JAX package maps the
per-device update over a mesh with shard_map (GSPMD cannot partition a
Pallas kernel); the port runs one process per rank, the `data` axis is
the process group (`core/mesh.py`), and each rank runs the single-device
update body on its own rows, through the port's kernels, with the
gradients and metrics averaged across the group inside the step (the
agent's `grad_axis`, `agents/sac.py`). Every rank holds the whole train
state, replicated, as JAX's `shardmap_learn` holds it.

Not ported yet (raising NotImplementedError by name): the `model` axis
(`sharded_learn` with model > 1), `shardmap_collect` and
`shardmap_fused_round`.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from dgvit_tpu_torch.agents.sac import SACAgent, SACState
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.core.mesh import AXIS_DATA, MeshRuntime, use_mesh

FLAVORS = ("plain", "per", "guided", "guided_per")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def shard_sac_state(runtime: MeshRuntime, state: SACState) -> SACState:
    """Rank 0's whole train state on every rank, in place: the modules'
    parameters, the three Adam states, log_alpha, the counter and the
    generators' states (`core/checkpoint.state_payload`). Returns it."""
    if runtime.world == 1:
        return state
    payload = runtime.broadcast_object(
        _to_cpu(ckpt.state_payload(state)) if runtime.rank == 0 else None)
    if runtime.rank != 0:
        ckpt.load_payload(state, payload)
    return state


def shard_batch(runtime: MeshRuntime, batch: Dict[str, Any]
                ) -> Dict[str, Any]:
    """The rank's rows of a global batch."""
    return runtime.shard_batch(batch)


def shardmap_learn(agent: SACAgent, runtime: MeshRuntime,
                   flavor: str = "plain"):
    """The data-parallel update of `flavor`: learn(state, batch, *args,
    noise=None, shifts=None) takes the GLOBAL batch and JAX's extra
    arguments, each rank updating on its rows:

      plain       learn(state, batch) -> (state, metrics)
      per         learn(state, batch, is_weights) -> (state, metrics, td)
      guided      learn(state, batch, expert_batch, n_expert)
                  -> (state, metrics)
      guided_per  learn(state, batch, expert_batch, n_expert, is_weights)
                  -> (state, metrics, td)

    is_weights (B,) are global and sliced like the batch; n_expert counts
    the valid rows of the global expert batch; `noise` is the global
    (next-action, policy) draw ((B, A) each, (B + Be, A) guided), as the
    single-device update takes it; td is the global batch's |TD error| in
    global row order, on every rank. `shifts` (DrQ offsets) are the
    rank's own. The agent must be built with grad_axis='data'."""
    if agent.grad_axis != AXIS_DATA:
        raise ValueError("build the agent with SACAgent(cfg, "
                         "grad_axis='data') so gradients sync over the "
                         "mapped axis")
    if flavor not in FLAVORS:
        raise ValueError(flavor)
    local = runtime.shard_batch
    step = {"plain": agent.learn, "per": agent.learn_per,
            "guided": agent.learn_guidence,
            "guided_per": agent.learn_guidence_per}[flavor]

    def learn(state: SACState, batch, *args, **kw):
        args = list(args)
        if flavor in ("guided", "guided_per"):
            args[0] = local(args[0])               # expert batch
        if flavor in ("per", "guided_per"):
            args[-1] = local(torch.as_tensor(args[-1]))  # is_weights
        with use_mesh(runtime):
            return step(state, local(batch), *args, **kw)

    return learn


def sharded_learn(agent: SACAgent, runtime: MeshRuntime):
    """The plain update on a data-only mesh (JAX's GSPMD step): the
    agent's data-parallel twin (grad_axis='data') under shardmap_learn.
    A `model` axis of more than one raises by name."""
    if runtime.mesh.model > 1:
        raise NotImplementedError(
            "sharded_learn over a 'model' axis (tensor parallelism) is not "
            "ported; use a data-only mesh")
    if agent.grad_axis != AXIS_DATA:
        agent = copy.copy(agent)
        agent.grad_axis, agent._rank_gens = AXIS_DATA, {}
    return shardmap_learn(agent, runtime, "plain")


def shardmap_collect(*args, **kwargs):
    """The lane-sharded on-device collection: not ported yet."""
    raise NotImplementedError(
        "shardmap_collect (the lane-sharded collection under the data "
        "mesh) is not ported yet")


def shardmap_fused_round(*args, **kwargs):
    """The fused training round under the data mesh: not ported yet."""
    raise NotImplementedError(
        "shardmap_fused_round (the fused round under the data mesh) is "
        "not ported yet")
