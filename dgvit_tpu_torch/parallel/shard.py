"""Sharded training: data parallelism over the `data` mesh axis.

Counterpart of `dgvit_tpu/parallel/shard.py`. The JAX package maps the
per-device update over a mesh with shard_map (GSPMD cannot partition a
Pallas kernel); the port runs one process per rank, the `data` axis is
the process group (`core/mesh.py`), and each rank runs the single-device
update body on its own rows, through the port's kernels, with the
gradients and metrics averaged across the group inside the step (the
agent's `grad_axis`, `agents/sac.py`). Every rank holds the whole train
state, replicated, as JAX's `shardmap_learn` holds it.

`shardmap_collect` and `shardmap_fused_round` put the on-device loop
(`train/vec_rollout.py`, `train/fused_train.py`) on the same design:
each rank steps its own lanes and keeps the ring rows they wrote, the
action noise is the global draw, and the round's stats are summed over
the group. The `model` axis (`sharded_learn` with model > 1) is not
ported and raises NotImplementedError by name.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from dgvit_tpu_torch.agents.sac import SACAgent, SACState
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.core.mesh import AXIS_DATA, MeshRuntime, use_mesh
from dgvit_tpu_torch.envs.vec_kinematic import VecState, vec_reset

FLAVORS = ("plain", "per", "guided", "guided_per")


def _need_data_axis(agent: SACAgent) -> None:
    if agent.grad_axis != AXIS_DATA:
        raise ValueError("build the agent with SACAgent(cfg, "
                         "grad_axis='data') so gradients sync over the "
                         "mapped axis")


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
    _need_data_axis(agent)
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


def _divides(world: int, **sizes) -> None:
    for name, n in sizes.items():
        if n % world:
            raise ValueError(f"{name} {n} does not split over the data "
                             f"axis of {world} ranks")


def rank_lanes(runtime: MeshRuntime, consts, n_envs: int):
    """The rank's lanes of vec_reset(consts, n_envs): contiguous and
    rank-major, as JAX's P('data') splits them."""
    state, obs, goal = vec_reset(consts, n_envs)
    rows = runtime.rows(n_envs)
    return (VecState(*(f[rows].clone() for f in state)),
            obs[rows].clone(), goal[rows].clone())


def shardmap_collect(agent: SACAgent, runtime: MeshRuntime, consts,
                     batch: int, chunk: int, l_scale: float, a_scale: float,
                     max_action: float = 1.0, evaluate: bool = False,
                     frame_stack: int = 0, fault_knobs=None,
                     aug_prob: float = 1.0):
    """The lane-sharded collection over the data axis (JAX
    `shardmap_collect`): each rank steps its own `batch / world` lanes of
    the batched env (`train/vec_rollout.make_collect_fn`, K1 at the
    rank's lanes); lanes are independent, so no collective runs. A lane's
    action noise is its row of the global draw and an auto-reset advances
    the record table by the global lane count, so the union of the
    ranks' lanes is the unsharded collector's; each rank draws its own
    sensor faults (`vec_rollout.rank_fault_generator`).

    Returns (collect, init): init() -> the rank's carry (its lanes of
    vec_reset(consts, batch), with `frame_stack` their stacks);
    collect(actor, carry, generator, noise=None, fault_gen=None,
    faults=None) -> (carry', traj), traj the rank's (T, b, ...)
    transitions; `noise` the global (T, batch, A) draws, `generator` the
    same on every rank. The agent must be built with grad_axis='data'."""
    from dgvit_tpu_torch.train.vec_rollout import make_collect_fn, stack_init

    _need_data_axis(agent)
    _divides(runtime.world, batch=batch)
    fn = make_collect_fn(agent, consts, chunk, l_scale, a_scale,
                         max_action=max_action, evaluate=evaluate,
                         stride=batch, frame_stack=frame_stack,
                         fault_knobs=fault_knobs, aug_prob=aug_prob)

    def init():
        state, obs, goal = rank_lanes(runtime, consts, batch)
        return state, stack_init(obs, frame_stack) if frame_stack else obs, \
            goal

    def collect(actor, carry, generator=None, noise=None, fault_gen=None,
                faults=None):
        with use_mesh(runtime):
            return fn(actor, carry, generator, noise, fault_gen, faults)

    return collect, init


def shardmap_fused_round(agent: SACAgent, runtime: MeshRuntime, consts,
                         n_envs: int, chunk: int, updates_per_round: int,
                         batch_size: int, ring_capacity: int,
                         l_scale: float, a_scale: float,
                         max_action: float = 1.0,
                         prioritized: bool = False, guided: bool = False,
                         fault_knobs=None, aug_prob: float = 1.0,
                         beta: float = 0.4, frame_stack: int = 0,
                         seed: int = 0):
    """The fused training round over the data axis (JAX
    `shardmap_fused_round`): lanes and ring rows split over the ranks
    (each rank keeps the transitions its lanes wrote and samples its
    `batch_size / world` rows from them: the global batch is uniform
    over the union, a rank's rows never mix into another's, JAX's
    documented deviation from single-device sampling), the train state
    replicated, the gradients and metrics averaged inside each update,
    the stats summed, PER's running max max-reduced at the end of each
    round. `train/fused_train.make_fused_round` under a `grad_axis` agent
    says what each rank draws. `n_envs`, `batch_size` and
    `ring_capacity` are global and must divide by the world size.

    Returns (run, init): init(obs_shape, pdim=2) -> (env_carry, ring) and
    with `prioritized` a third, the PER state: the rank's lanes, a
    `DeviceRing` of ring_capacity / world rows and its `DevicePER`;
    run(state, env_carry, ring, rounds, expert=None, draws=None,
    per=None) -> make_fused_round's results, `expert` the whole staged
    corpus on every rank. The agent must be built with
    grad_axis='data'."""
    from dgvit_tpu_torch.replay.device_per import per_init
    from dgvit_tpu_torch.train.fused_train import make_fused_round, ring_init
    from dgvit_tpu_torch.train.vec_rollout import stack_init

    _need_data_axis(agent)
    world = runtime.world
    _divides(world, n_envs=n_envs, batch_size=batch_size,
             ring_capacity=ring_capacity)
    run_local = make_fused_round(
        agent, consts, n_envs // world, chunk, updates_per_round,
        batch_size // world, l_scale, a_scale, max_action=max_action,
        stride=n_envs, prioritized=prioritized, beta=beta,
        frame_stack=frame_stack, guided=guided, fault_knobs=fault_knobs,
        aug_prob=aug_prob, seed=seed)

    def init(obs_shape, pdim: int = 2):
        state, obs, goal = rank_lanes(runtime, consts, n_envs)
        carry = (state, stack_init(obs, frame_stack) if frame_stack
                 else obs, goal)
        ring = ring_init(ring_capacity // world, tuple(obs_shape), pdim=pdim,
                         device=runtime.device)
        if prioritized:
            return carry, ring, per_init(ring_capacity // world,
                                         runtime.device)
        return carry, ring

    def run(state: SACState, env_carry, ring, rounds, expert=None,
            draws=None, per=None):
        with use_mesh(runtime):
            return run_local(state, env_carry, ring, rounds, expert, draws,
                             per)

    return run, init
