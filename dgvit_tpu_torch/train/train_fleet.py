"""Fleet-collection training: N robots collect while ONE learner updates.

Counterpart of `dgvit_tpu/train/train_fleet.py`. The reference trains
while it collects on one robot: every env step stores a transition and
runs one SAC update (main.py:369-394). The fleet form of that loop:

    robot_0..N-1 threads ──► BatchingActorServer ──► one K1 dispatch
         │  on_transition        (stochastic actions   (coalesced padded
         ▼                        of the served copy)   buckets)
    thread-safe replay ring  ◄── learner thread: SAC updates off the
    (replay/buffer.py, C++)       shared buffer; after every update the
                                  learner's actor is published into the
                                  served copy (latest wins: a dispatch
                                  may act on a policy one update old)

As in the JAX loop: actions are batched and stochastic through the
serving layer; the update:step cadence is a target ratio
(`updates_per_step`, 1.0 = the reference's) that the learner tracks, and
collection never waits on it; after collection ends the learner drains to
the cadence; there is no human intervention (engage 0: a fleet has no
teleop seat). Plain, PER, guided (PRE_BUFFER) and guided PER updates are
dispatched as `train/train_rl.py` dispatches them.

The params mailbox. JAX publishes an immutable parameter tree; the port's
Adam updates `state.actor` in place, and `GoT.fused_params` rebuilds K1's
cast weights whenever a parameter's version moves. So the server acts on
a separate served copy of the actor, and the learner publishes into it
with `copy_` under `dev_lock`; the server's `act_batch` (the cast-cache
check and the K1 enqueue) runs under the same lock, so a dispatch never
reads a half-published copy. Nothing that waits on the device runs under
the lock (JAX's round-5 rule, PARITY.md:133): the update itself (its
host syncs), PER's |td| readback, the frames' staging and the action's
`.cpu()` all run outside it. Both threads stay on the default stream,
which orders every publish and every dispatch as they were enqueued.

Every kernel library the learner and the server launch is built and
loaded before any robot moves (`ops.load_kernels`; `ops/_build.py`
serializes builds across threads), and the serving buckets are warmed
then, so no compile runs mid-campaign. Collection draws its action noise from a CUDA generator
that only the server thread uses, seeded step_key(train.seed,
FLEET_STREAM) (JAX's RngStream in that role).

`--mesh-data N` shards the learner over the data axis (JAX
`train_fleet.py:104-131`), one process a rank under `torchrun
--nproc-per-node N`: N is the process group's world size. Rank 0 runs the
robots, the serving thread, the replay buffer and the sampling; it acts
through an agent without `grad_axis`, as JAX's `act_agent`, so the
fleet's action stream does not move. For each update it broadcasts a
header (the flavour, n_expert and the arrays' shapes, or stop) and then
the global batch, with the guided flavours the expert batch and with PER
the importance weights, as one flat buffer; every rank then runs
`parallel.shardmap_learn`'s flavour on its rows (`batch_size` stays the
global batch), and rank 0 updates the priorities from the global td. The
ranks 1..N-1 run a follower loop that only receives and updates. The
update's action noise is drawn by every rank from the train state's own
generator, which is replicated, so it needs no broadcast (a broadcast
noise would leave the followers' generators behind rank 0's). The state
is rank 0's, replicated (`shard_sac_state`) after init, a warm start and
a resume, which rank 0 alone reads; every rank holds it after every
update, and rank 0 alone writes checkpoints and the final actor.
"""

from __future__ import annotations

import argparse
import copy
import os
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config, load_reference_yaml
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.core import distributed
from dgvit_tpu_torch.core.mesh import MeshRuntime
from dgvit_tpu_torch.core.rng import generator, step_key
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.models.jax_io import params_to_jax
from dgvit_tpu_torch.ops import load_kernels
from dgvit_tpu_torch.replay import (PrioritizedReplayBuffer, ReplayBuffer,
                                    reference_schema)
from dgvit_tpu_torch.replay.staging import HostStager
from dgvit_tpu_torch.serve import BatchingActorServer, FleetRunner
from dgvit_tpu_torch.serve.fleet import fleet_buckets
from dgvit_tpu_torch.train.train_rl import Updater, expert_buffer
from dgvit_tpu_torch.utils import MetricsLogger

FLEET_STREAM = 0xF1   # step_key tag of collection's action-noise generator
LOGGED = ("alpha", "policy_loss", "qf1_loss", "entropy")


class _Collector:
    """Thread-safe on_transition consumer: the robot threads feed the
    shared replay buffer (its add() holds the buffer's lock); the counters
    have their own lock so the learner reads a consistent step count."""

    def __init__(self, buf):
        self.buf = buf
        self.steps = 0
        self.episodes_done = 0
        self._lock = threading.Lock()

    def __call__(self, robot, obs, a, goal, rew, next_obs, next_goal, done):
        # demo-npz row layout -> the reference buffer schema
        # (main.py:385-392); engage 0: no teleop seat in a fleet
        self.buf.add(obs=obs, act=a, pobs=goal[:2], next_pobs=next_goal[:2],
                     rew=rew, next_obs=next_obs, engage=0.0,
                     done=float(done))
        with self._lock:
            self.steps += 1
            if done:
                self.episodes_done += 1


def _build_expert_buffer(cfg: Config, expert_glob: Optional[str], obs_shape):
    """The PRE_BUFFER expert buffer (main.py:223-268) and its size, or
    (None, 0): the host loop's transform."""
    if not (cfg.train.pre_buffer and expert_glob):
        return None, 0
    return expert_buffer(cfg, expert_glob, obs_shape,
                         cfg.model.patch_mode == "channels")


def _read_weights(actor: torch.nn.Module) -> list:
    """The tensors a dispatch reads: each fused trunk's casts as K1 takes
    them (`GoT.fused_params`, rebuilt first if a parameter moved, as
    `act_batch` does) and every other parameter as it is."""
    out, in_trunk = [], set()
    for m in actor.modules():
        if hasattr(m, "fused_params"):
            pe, pos, blocks, fn = m.fused_params(m.compute_dtype
                                                 or torch.float32)
            out += [*pe, pos, *(x for blk in blocks for x in blk), *fn]
            in_trunk.update(id(p) for p in m.parameters())
    return out + [p.detach() for p in actor.parameters()
                  if id(p) not in in_trunk]


def _unpack(flat: torch.Tensor, spec) -> dict:
    out, i = {}, 0
    for group, key, shape in spec:
        n = int(np.prod(shape, dtype=np.int64))
        part = flat[i:i + n].reshape(shape)
        i += n
        if key is None:
            out[group] = part
        else:
            out.setdefault(group, {})[key] = part
    return out


def send_update(rt: MeshRuntime, flavor: Optional[str], n_expert: int = 0,
                arrays: Optional[dict] = None) -> Optional[dict]:
    """Rank 0's side of an update's exchange: the header (the flavour, or
    None to stop, n_expert and the arrays' shapes) as an object, then
    every array in float32 as one flat buffer. `arrays`: {'batch': {...},
    'expert': {...}, 'weights': array}, the groups the flavour needs.
    Returns the arrays as the followers receive them."""
    spec = []
    parts = []
    for group, val in (arrays or {}).items():
        items = val.items() if isinstance(val, dict) else [(None, val)]
        for key, a in items:
            a = torch.as_tensor(np.asarray(a, np.float32))
            spec.append((group, key, tuple(a.shape)))
            parts.append(a.reshape(-1))
    rt.broadcast_object({"flavor": flavor, "n_expert": int(n_expert),
                         "spec": spec})
    if flavor is None:
        return None
    return _unpack(rt.broadcast_(torch.cat(parts)), spec)


def receive_update(rt: MeshRuntime):
    """A follower's side of `send_update`: (flavour, n_expert, arrays),
    or None when rank 0 stops."""
    head = rt.broadcast_object(None)
    if head["flavor"] is None:
        return None
    n = sum(int(np.prod(shape, dtype=np.int64))
            for _, _, shape in head["spec"])
    flat = rt.broadcast_(torch.empty(n, dtype=torch.float32))
    return head["flavor"], head["n_expert"], _unpack(flat, head["spec"])


def mesh_learn(learn_fns: dict, state, flavor: str, n_expert: int,
               arrays: dict):
    """One data-parallel update of `flavor` on the exchanged global arrays
    (`parallel.shardmap_learn`): (state, metrics, td or None)."""
    args = {"plain": (), "per": (arrays.get("weights"),),
            "guided": (arrays.get("expert"), n_expert),
            "guided_per": (arrays.get("expert"), n_expert,
                           arrays.get("weights"))}[flavor]
    res = learn_fns[flavor](state, arrays["batch"], *args)
    return res[0], res[1], (res[2] if len(res) == 3 else None)


def follow(rt: MeshRuntime, state, learn_fns: dict):
    """Ranks 1..N-1 of the sharded fleet learner: receive each update's
    global arrays from rank 0 and run it, until rank 0 stops. (state,
    updates)."""
    updates = 0
    while True:
        msg = receive_update(rt)
        if msg is None:
            return state, updates
        state = mesh_learn(learn_fns, state, *msg)[0]
        updates += 1


def _checksum(tensors) -> torch.Tensor:
    """A float64 sum of every element, left on the device."""
    return torch.cat([x.reshape(-1).double() for x in tensors]).sum()


class FleetLearner:
    """Both sides of the params mailbox. The learner's: one SAC update at
    a time off the shared buffer (`train_rl.Updater`), published into the
    served copy under `dev_lock` before PER's |td| readback. The server's:
    `dispatch`, the cast-cache check and K1's enqueue on the served copy
    under the same lock. Neither waits on the device under the lock.

    `audit` ({'published': [], 'dispatched': []} or None): each publish
    appends the float64 checksum of the casts and parameters a dispatch
    would read of the version it publishes (computed from the learner's
    actor), and each dispatch the checksum of those it reads of the
    served copy; both stay on the device."""

    def __init__(self, agent: SACAgent, cfg: Config, buf, served,
                 dev_lock: threading.Lock, expert_buf=None,
                 expert_size: int = 0, audit: Optional[dict] = None,
                 runtime: Optional[MeshRuntime] = None,
                 learn_fns: Optional[dict] = None):
        self.agent, self.served, self.dev_lock = agent, served, dev_lock
        self.audit = audit
        self.updater = Updater(agent, cfg, buf, expert_buf, expert_size,
                               guided=expert_buf is not None)
        self.runtime, self.learn_fns = runtime, learn_fns
        self.flavor = {(False, False): "plain", (False, True): "per",
                       (True, False): "guided", (True, True): "guided_per"}[
            expert_buf is not None, bool(cfg.sac.prioritized_replay)]

    def publish(self, state) -> None:
        """The learner's actor into the served copy (enqueued copies, no
        wait), under the lock."""
        with self.dev_lock, torch.no_grad():
            for dst, src in zip(self.served.parameters(),
                                state.actor.parameters()):
                dst.copy_(src)
            for dst, src in zip(self.served.buffers(), state.actor.buffers()):
                dst.copy_(src)
            if self.audit is not None:
                self.audit["published"].append(
                    _checksum(_read_weights(state.actor)))

    def dispatch(self, obs: torch.Tensor, pobs: torch.Tensor,
                 gen: Optional[torch.Generator]) -> torch.Tensor:
        """Stochastic actions of the served copy for device-resident
        frames and goals, enqueued under the lock and not waited for."""
        with self.dev_lock:
            if self.audit is not None:
                self.audit["dispatched"].append(
                    _checksum(_read_weights(self.served)))
            return self.agent.act_batch(self.served, obs, pobs, gen)

    def sample_host(self):
        """One update's global draws on the host, for the data axis:
        (n_expert, {'batch', 'expert', 'weights'} as the flavour needs
        them, the sampled rows or None)."""
        u, s = self.updater, self.updater.s
        d = u.buf.sample(s.batch_size)
        w, idx = d.pop("weights", None), d.pop("indexes", None)
        arrays, k = {"batch": d}, 0
        if self.flavor.startswith("guided"):
            k = self.agent.expert_batch_size(
                u.expert_size, u.buf.get_stored_size(), s.batch_size)
            eb = u.expert_buf.sample(s.batch_size)
            eb["act"] = eb.pop("act_exp")
            arrays["expert"] = eb
        else:
            d.pop("engage", None)
        if self.flavor.endswith("per"):
            arrays["weights"] = w
        return k, arrays, idx

    def update(self, state):
        """One update of the host loop's flavour, minus the intervention
        branch; (state, metrics). On the data axis rank 0 draws the global
        arrays, sends them to the followers and runs its rows of the
        update with them."""
        if self.runtime is not None:
            k, arrays, idx = self.sample_host()
            arrays = send_update(self.runtime, self.flavor, k, arrays)
            state, metrics, td = mesh_learn(self.learn_fns, state,
                                            self.flavor, k, arrays)
            self.publish(state)
            if td is not None:
                self.updater.update_priorities(td, idx)
            return state, metrics
        drawn = self.updater.sample()
        state, metrics, td, idx = self.updater.learn(state, drawn)
        self.publish(state)
        if td is not None:
            # waits for the update: outside dev_lock by design
            self.updater.update_priorities(td, idx)
        return state, metrics


def train_fleet(cfg: Config, envs: Sequence, out_dir: str = "results",
                max_episodes: int = 100, expert_glob: Optional[str] = None,
                updates_per_step: float = 1.0, max_wait_ms: float = 4.0,
                log_every_updates: int = 200, mesh_data: int = 0,
                resume: bool = False, save_every_updates: int = 500,
                device: Optional[Union[str, torch.device]] = None,
                audit: bool = False) -> dict:
    """Train one SAC learner from N concurrently collecting robots.

    envs: Env-protocol robots (KinematicNavEnv lanes, or namespaced
    GazeboRos2Env adapters from serve.make_ros2_fleet for a live world).
    max_episodes: the total episode budget, split evenly across robots.
    updates_per_step: the target learner updates per collected env step
    (1.0 = the reference's cadence, main.py:394). Runs on the card unless
    device='cpu'. With train.save: full train-state checkpoints every
    `save_every_updates` updates (the newest 3 kept) and at the end, and
    the final actor as models/fleet_<desc>_actor.npz in the JAX package's
    layout. `audit`: a float64 checksum of what K1 reads (the trunk's
    casts and the other parameters, `FleetLearner`) of every published
    version and at every dispatch, kept on the device and read after the
    campaign (out['audit']: 'published', the initial copy's first, and
    'dispatched', the warm-up's excluded). out['learner'] is the
    `FleetLearner`, its `publish` and `dispatch` reusable after the run.

    `mesh_data` N > 0: the learner over the data axis of the process
    group (module docstring), which must have N ranks (`torchrun
    --nproc-per-node N`; one process with N = 1). Rank 0 runs the fleet
    and returns the result above; the other ranks take `envs` empty and
    return {'state', 'updates', 'rank'} once rank 0 stops.
    """
    from dgvit_tpu_torch.parallel import shard_sac_state, shardmap_learn

    t, e, s = cfg.train, cfg.env, cfg.sac
    rt = None
    if mesh_data:
        distributed.initialize()
        world = distributed.world_size()
        if mesh_data != world:
            raise ValueError(
                f"--mesh-data {mesh_data}: the process group has {world} "
                f"rank(s); start one process a rank (torchrun "
                f"--nproc-per-node {mesh_data})")
        rt = MeshRuntime.create(data=mesh_data, device=device)
        device = rt.device
    n_robots = len(envs)
    if (rt is None or rt.rank == 0) and max_episodes % n_robots:
        raise ValueError(f"max_episodes {max_episodes} must divide evenly "
                         f"across {n_robots} robots")
    agent = SACAgent(cfg, device=device, seed=t.seed)
    dev = agent.device
    state = agent.init_state(t.seed)
    ckpt_dir = os.path.join(out_dir, t.checkpoint_dir)
    if rt is None or rt.rank == 0:
        if t.pre_train and t.pre_train_model:  # IL warm start
            d, f = os.path.split(t.pre_train_model)   # (main.py:272-274)
            state = agent.load(state, f, d or ".", actor_only=True)
        if resume:
            latest = ckpt.latest_checkpoint(ckpt_dir)
            if latest is not None:
                state = ckpt.restore_train_state(latest, state)
                print(f"[train_fleet] resumed train state from {latest} "
                      f"(itera={int(state.itera)})", flush=True)
    learn_fns = None
    if rt is not None:
        # the learner on the data axis; `agent` (no grad_axis) acts
        learner_agent = SACAgent(cfg, device=dev, seed=t.seed,
                                 grad_axis="data")
        learn_fns = {f: shardmap_learn(learner_agent, rt, f)
                     for f in ("plain", "per", "guided", "guided_per")}
        state = shard_sac_state(rt, state)
        if dev.type == "cuda":
            load_kernels()
        if rt.rank != 0:
            state, updates = follow(rt, state, learn_fns)
            return {"state": state, "updates": updates, "rank": rt.rank}

    ih, iw = cfg.model.image_size
    obs_shape = ((e.frame_stack, ih, iw)
                 if cfg.model.patch_mode == "channels" else (ih, iw))
    buf_cls = PrioritizedReplayBuffer if s.prioritized_replay else ReplayBuffer
    buf = buf_cls(s.buffer_size,
                  reference_schema(obs_shape, s.action_dim, s.pstate_dim),
                  seed=t.seed)
    expert_buf, expert_size = _build_expert_buffer(cfg, expert_glob,
                                                   obs_shape)
    collector = _Collector(buf)
    logger = MetricsLogger(out_dir, f"train_fleet_{cfg.model.name}_{t.desc}")

    # the served copy: what the server acts on, published into after every
    # update (see the module docstring)
    served = copy.deepcopy(state.actor).requires_grad_(False).eval()
    dev_lock = threading.Lock()
    sums = {"published": [], "dispatched": []} if audit else None
    learner = FleetLearner(agent, cfg, buf, served, dev_lock, expert_buf,
                           expert_size, audit=sums, runtime=rt,
                           learn_fns=learn_fns)
    if audit:
        learner.publish(state)      # the initial copy's checksum
    gen = generator(step_key(t.seed, FLEET_STREAM), dev)
    stagers: dict = {}

    def serve_act(obs, goal):  # the server's worker thread, batched
        # stochastic actions: this is collection, not evaluation. Stage
        # outside the lock; enqueue the cast check and K1 under it; wait
        # for the action outside it.
        b = obs.shape[0]
        if b not in stagers:
            stagers[b] = HostStager(dev)
        d, _ = stagers[b].put({"obs": obs, "pobs": goal})
        a = learner.dispatch(d["obs"], d["pobs"], gen)
        return a.float().cpu().numpy()

    buckets = fleet_buckets(n_robots)
    # build every kernel and warm every bucket before any robot moves: a
    # compile mid-campaign would stall every robot coalesced behind it
    if dev.type == "cuda":
        load_kernels()
    for b in buckets:
        serve_act(np.zeros((b,) + obs_shape, np.float32),
                  np.zeros((b, 2), np.float32))
    if sums is not None:
        sums["dispatched"].clear()      # the campaign's dispatches only

    fleet_out: dict = {}
    t0 = time.time()
    updates = 0
    metrics: dict = {}
    with BatchingActorServer(serve_act, max_wait_ms=max_wait_ms,
                             buckets=buckets) as srv:
        runner = FleetRunner(envs, srv, cfg, on_transition=collector)

        def collect():
            fleet_out.update(runner.run(
                episodes_per_robot=max_episodes // n_robots))

        col_thread = threading.Thread(target=collect, daemon=True)
        col_thread.start()
        while True:
            collecting = col_thread.is_alive()
            behind = (buf.get_stored_size() >= s.batch_size
                      and updates < collector.steps * updates_per_step)
            if behind:
                state, metrics = learner.update(state)
                updates += 1
                if log_every_updates and updates % log_every_updates == 0:
                    logger.log(updates, steps=collector.steps,
                               episodes=collector.episodes_done,
                               **{k: float(v) for k, v in metrics.items()
                                  if k in LOGGED})
                if (t.save and save_every_updates
                        and updates % save_every_updates == 0):
                    # the learner's own state: the server never reads it,
                    # so no lock (and no device wait under one)
                    ckpt.save_train_state(ckpt_dir, int(state.itera), state)
                    ckpt.prune_checkpoints(ckpt_dir, keep=3)
            elif collecting:
                time.sleep(0.001)  # wait for fresh experience
            else:
                break  # collection finished and the learner caught up
        col_thread.join()
    if rt is not None:
        send_update(rt, None)        # the followers stop
    srv_stats = srv.stats()

    wall = time.time() - t0
    actor_npz = None
    if t.save:
        ckpt.save_train_state(ckpt_dir, int(state.itera), state)
        actor_npz = ckpt.save_params_npz(
            os.path.join(out_dir, "models"), f"fleet_{t.desc}",
            params_to_jax(state.actor.state_dict()))
    out = {
        "state": state,
        "served": served,
        "episodes": fleet_out.get("episodes", 0),
        "successes": fleet_out.get("successes", 0),
        "collisions": fleet_out.get("collisions", 0),
        "errors": fleet_out.get("errors", {}),
        "env_steps": collector.steps,
        "updates": updates,
        "wall_s": wall,
        "steps_per_s": collector.steps / max(wall, 1e-9),
        "updates_per_s": updates / max(wall, 1e-9),
        "serving": srv_stats,
        "warm_dispatches": len(buckets),
        "actor_npz": actor_npz,
        "learner": learner,
    }
    if sums is not None:
        out["audit"] = {k: (torch.stack(v).cpu().tolist() if v else [])
                        for k, v in sums.items()}
    logger.log(updates, final=1, **{k: v for k, v in out.items()
                                    if isinstance(v, (int, float))})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description="dgvit_tpu_torch fleet-collection RL training: N "
                    "robots, one shared batching actor server, one SAC "
                    "learner (PyTorch/CUDA)")
    p.add_argument("--config", help="structured YAML config")
    p.add_argument("--reference-config",
                   help="reference-format config.yaml to translate")
    p.add_argument("--fleet", type=int, default=4, help="number of robots")
    p.add_argument("--episodes", type=int, default=100,
                   help="total episode budget across the fleet")
    p.add_argument("--world", default="rrc", choices=["rrc", "hospital"])
    p.add_argument("--env", default="kinematic", choices=["kinematic", "ros2"])
    p.add_argument("--expert-glob", default=None,
                   help="demo npz glob for PRE_BUFFER guided updates")
    p.add_argument("--updates-per-step", type=float, default=1.0,
                   help="target learner updates per collected env step "
                        "(reference cadence = 1.0, main.py:394)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="shard the learner over a data mesh of N ranks "
                        "(parallel.shardmap_learn), one process a rank: "
                        "torchrun --nproc-per-node N; batch_size stays the "
                        "global batch")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend under --mesh-data "
                        "(default: NCCL when each rank has a card of its "
                        "own; gloo where ranks share a card)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest train-state checkpoint (warm "
                        "weights; the replay buffer refills from fresh "
                        "collection)")
    p.add_argument("--save-every-updates", type=int, default=500,
                   help="periodic full-train-state checkpoint cadence "
                        "(0 = final save only)")
    p.add_argument("--out", default="results")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    args = p.parse_args(argv)

    if args.reference_config:
        cfg = load_reference_yaml(args.reference_config)
    elif args.config:
        cfg = Config.from_yaml(args.config)
    else:
        cfg = Config()

    if args.mesh_data:
        distributed.initialize(backend=args.dist_backend)
    if distributed.rank() != 0:
        envs = []            # a follower of the sharded learner
    elif args.env == "kinematic":
        envs = [KinematicNavEnv(seed=cfg.train.seed + i,
                                image_hw=tuple(cfg.model.image_size),
                                world=args.world)
                for i in range(args.fleet)]
    else:
        from dgvit_tpu_torch.serve import make_ros2_fleet
        envs = make_ros2_fleet(cfg, args.fleet, device=args.device)

    out = train_fleet(cfg, envs, out_dir=args.out,
                      max_episodes=args.episodes,
                      expert_glob=args.expert_glob,
                      updates_per_step=args.updates_per_step,
                      mesh_data=args.mesh_data, resume=args.resume,
                      save_every_updates=args.save_every_updates,
                      device=args.device)
    if "rank" in out:
        print(f"fleet learner rank {out['rank']}: {out['updates']} updates")
        return
    print(f"fleet train done: {out['successes']} successes / "
          f"{out['episodes']} episodes / {out['env_steps']} steps / "
          f"{out['updates']} updates in {out['wall_s']:.1f} s "
          f"({out['steps_per_s']:.1f} steps/s, "
          f"{out['updates_per_s']:.1f} updates/s, mean batch "
          f"{out['serving']['mean_batch']:.2f})")
    if out["errors"]:
        raise SystemExit(f"robots failed: {out['errors']}")


if __name__ == "__main__":
    main()
