"""On-device SAC training: collection, a replay ring and the updates, all
on the card, rounds at a time.

Counterpart of `dgvit_tpu/train/fused_train.py`, the loop that trained the
repository's recorded actors. A round collects B lanes x T steps of the
batched env (`train/vec_rollout.make_collect_fn`, acting through K1),
writes every transition into a replay ring that lives on the card
(`DeviceRing`), then runs U updates (`SACAgent.learn`, or
`learn_guidence` with an expert corpus staged on the card once) on
uniform minibatches of the ring (K4, K2f/K2b, K3f/K3b). With
`sac.prioritized_replay` the round keeps the ring's priorities on the card
as well (`replay/device_per.py`): the new rows take the max priority, each
update draws its minibatch in proportion to them (`per_sample`), runs
`learn_per` (or `learn_guidence_per`) with the importance weights and
gives the drawn rows |td| + 1e-6 (`per_update`). JAX runs R rounds
as one dispatch; here Python drives each step and each update, and the
host reads the card once a round (the stats), besides the reads `learn`
itself makes.

The replay semantics are the JAX loop's, which differ from the host
trainer's on purpose: the ring stores every transition, each episode's
first step included (the host loops skip it), sampling is uniform over
the filled part (or proportional with PER), and the capacity is
bounded by device memory (obs and next_obs take 2 x cap x H x W x 4
bytes: 1.34 GB for 8192 frames of 128x160; the priorities 4 x cap bytes).

Randomness: round r's collection noise and minibatch draws come from
a generator seeded `core.rng.step_key(seed, r)`, so a resumed run draws
what it would have drawn without the restart; dropout masks and the
update's action noise come from the train state's own generator. PER's
priorities are not saved: after a warm resume every restored row is back
at the max priority, as cpprb's load_transitions leaves them. With
sensor-fault augmentation (`fault_knobs`, `aug_prob`) round r's fault
draws come from a generator of their own, seeded
`step_key(step_key(seed, r), FAULT_FOLD)`: the action noise and the
minibatches stay as they were, and resumes still draw as an unbroken run.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.agents.sac import PER_METRICS, PLAIN_METRICS, SACState
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.core.device import resolve_device
from dgvit_tpu_torch.core.rng import generator, step_key
from dgvit_tpu_torch.envs.vec_kinematic import (EnvConsts, make_consts,
                                                vec_reset)
from dgvit_tpu_torch.replay.device_per import (DevicePER, per_init,
                                               per_on_write, per_sample,
                                               per_update)
from dgvit_tpu_torch.train.vec_rollout import (frame_stack_depth,
                                               make_collect_fn, stack_init)
from dgvit_tpu_torch.utils import MetricsLogger

RING_FIELDS = ("obs", "act", "pobs", "next_pobs", "rew", "next_obs", "done")
# the fold of a round's seed that seeds its fault draws (JAX folds 101
# into the step key for them, apart from the action key)
FAULT_FOLD = 101


@dataclass
class DeviceRing:
    """A uniform replay ring on the device (the replay schema's fields but
    engage). `cursor` counts every row ever written, on the host: each
    write advances it by a known count, so no read of the card is needed
    to know how full the ring is."""
    obs: torch.Tensor        # (cap, h, w) or (cap, C, h, w)
    act: torch.Tensor        # (cap, 2)
    pobs: torch.Tensor       # (cap, p)
    next_pobs: torch.Tensor  # (cap, p)
    rew: torch.Tensor        # (cap,)
    next_obs: torch.Tensor   # like obs
    done: torch.Tensor       # (cap,)
    cursor: int = 0

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    @property
    def size(self) -> int:
        return min(self.cursor, self.capacity)


def ring_init(capacity: int, obs_shape: Tuple[int, ...], pdim: int = 2,
              device: Optional[Union[str, torch.device]] = None
              ) -> DeviceRing:
    """An empty ring on the card (or on `device`). `obs_shape`: (H, W), or
    (C, H, W) in channels mode."""
    dev = resolve_device(device)
    z = lambda *s: torch.zeros((capacity,) + s, device=dev)
    return DeviceRing(obs=z(*obs_shape), act=z(2), pobs=z(pdim),
                      next_pobs=z(pdim), rew=z(), next_obs=z(*obs_shape),
                      done=z())


def ring_rows(ring: DeviceRing, n: int) -> torch.Tensor:
    """The slots the next `n` rows written go to."""
    return (torch.arange(n, device=ring.obs.device) + ring.cursor) \
        % ring.capacity


def ring_write(ring: DeviceRing, rows: Dict[str, torch.Tensor]
               ) -> DeviceRing:
    """Write N rows (a dict of (N, ...) tensors) at the cursor, in place,
    wrapping modulo the capacity."""
    n = rows["obs"].shape[0]
    idx = ring_rows(ring, n)
    for f in RING_FIELDS:
        dst = getattr(ring, f)
        dst.index_copy_(0, idx, rows[f].to(dst.dtype).reshape(
            (n,) + dst.shape[1:]))
    ring.cursor += n
    return ring


def ring_gather(ring: DeviceRing, idx: torch.Tensor) -> Dict:
    """The rows `idx` as a learn batch (rew and done as (b, 1))."""
    out = {f: getattr(ring, f)[idx] for f in RING_FIELDS}
    out["rew"] = out["rew"][:, None]
    out["done"] = out["done"][:, None]
    return out


def ring_sample(ring: DeviceRing, gen: Optional[torch.Generator],
                batch: int) -> Dict:
    """A uniform minibatch of the filled part."""
    idx = torch.randint(0, max(ring.size, 1), (batch,), generator=gen,
                        device=ring.obs.device)
    return ring_gather(ring, idx)


def ring_save(ring: DeviceRing, path: str, chunk_rows: int = 1024) -> None:
    """Snapshot the ring to an uncompressed npz, copying it to the host
    `chunk_rows` rows at a time into one host array a field; written to a
    temporary name and renamed, so a crash never leaves a torn
    snapshot."""
    out = {}
    for f in RING_FIELDS:
        v = getattr(ring, f)
        host = np.empty(tuple(v.shape), np.float32)
        for i in range(0, v.shape[0], chunk_rows):
            host[i:i + chunk_rows] = v[i:i + chunk_rows].cpu().numpy()
        out[f] = host
    out["cursor"] = np.asarray(ring.cursor, np.int64)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)


def ring_load(path: str, like: DeviceRing) -> Optional[DeviceRing]:
    """Restore a snapshot into `like` (a ring of the configured geometry),
    in place; None, and `like` untouched, when the snapshot's geometry
    differs (another capacity or image size)."""
    with np.load(path) as d:
        if any(f not in d.files for f in RING_FIELDS + ("cursor",)):
            return None
        host = {f: d[f] for f in RING_FIELDS}
        cursor = int(d["cursor"])
    if any(v.shape != tuple(getattr(like, f).shape)
           for f, v in host.items()):
        return None
    for f, v in host.items():
        getattr(like, f).copy_(torch.from_numpy(v))
    like.cursor = cursor
    return like


GUIDED_METRICS = ("qf1_loss", "qf2_loss", "policy_loss", "alpha_loss",
                  "alpha", "n_expert", "guidence_weight")
ROUND_STATS = ("reward_sum", "goals", "collisions", "episodes")


def expert_rows(n_expert_total: int, size: int, batch: int) -> int:
    """The guided update's valid expert rows (DRL.py:195), in fp32 as the
    JAX round takes it: min(floor(N / size * batch), batch)."""
    f = np.float32
    return int(min(np.floor(f(n_expert_total) / f(max(size, 1))
                            * f(batch)), batch))


def rank_rows(td: torch.Tensor, rank: int, b: int) -> torch.Tensor:
    """The rank's `b` rows of a global, rank-major td: what its
    priorities take under the data axis."""
    return td[rank * b:(rank + 1) * b]


def group_reduce(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """`t` summed (or max-reduced) over the mesh's group, in place: one
    all_reduce (JAX's psum / pmax over the data axis)."""
    if mesh is not None and mesh.data > 1:
        import torch.distributed as dist
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=mesh.group)
    return t


def make_fused_round(agent: SACAgent, consts: EnvConsts, n_envs: int,
                     chunk: int, updates_per_round: int, batch_size: int,
                     l_scale: float, a_scale: float,
                     max_action: float = 1.0,
                     stride: Optional[int] = None,
                     prioritized: bool = False, beta: float = 0.4,
                     frame_stack: int = 0,
                     guided: bool = False, fault_knobs=None,
                     aug_prob: float = 1.0, seed: int = 0):
    """`run(state, env_carry, ring, rounds, expert=None, draws=None,
    per=None) -> (state, env_carry, ring, stats)`, and the PER state after
    them as a fifth element when `prioritized`: the rounds `rounds` (their
    indices,
    e.g. range(done, done + R)), each [collect `chunk` steps of the
    `n_envs` lanes -> write every transition into the ring -> if the ring
    holds `batch_size` rows, `updates_per_round` updates]. The state and
    the ring are updated in place. stats: (R,) numpy arrays of each
    round's reward_sum, goals, collisions, episodes, buffer and the last
    update's metrics in fp32 (zeros before the ring fills; no entropy with
    PER), with skipped_nonfinite under sac.nan_guard.

    `prioritized` keeps `per` (a `DevicePER` of the ring's capacity,
    required then, updated in place): each round's new rows take the max
    priority; each update draws its rows by `per_sample` (IS exponent
    `beta`), runs `learn_per` (`learn_guidence_per` when guided) with the
    weights and gives the rows |td| + 1e-6 by `per_update`.

    `guided` runs every update through `learn_guidence` on a uniform
    expert minibatch of `expert` (a dict of (N, ...) tensors on the card
    with the ring's field names, rew and done (N, 1)), of which
    `expert_rows(N, ring size, batch)` rows are valid, and engage all
    zero.

    `draws`, one dict a round, replaces the round's random draws (tests):
    'act_noise' (T, B, A) action noise, 'ring_idx' (U, b) and
    'expert_idx' (U, b) minibatch rows, 'per_u' (U, b) PER's uniform
    draws (in place of 'ring_idx'), 'update_noise' U pairs of
    (next-action, policy) row noise for `learn`'s `noise`, and with
    `fault_knobs` 'fault', collection's fault draws (`make_collect_fn`'s
    `faults`).

    `fault_knobs` and `aug_prob`: collection's sensor-fault augmentation
    (`make_collect_fn`), its draws from round r's fault generator.

    With a `grad_axis='data'` agent the round runs under the active mesh
    (`parallel/shard.shardmap_fused_round`), JAX's sharded round
    (`fused_train.py:145-330`): `n_envs`, `batch_size` and the ring (and
    PER's state) are the rank's own, `stride` the global lane count. The
    round's generator is the same on every rank, so every rank draws the
    same local ring indices, PER uniforms and expert indices (the expert
    minibatch is the same `batch_size` rows on every rank, as in JAX);
    the collection noise and each update's noise are global, a rank's
    rows of the update being its rank-major share of the union of the
    ranks' minibatches. The guided update's valid expert rows count at
    global scale, expert_rows(N, size x world, batch x world); PER's
    priorities take the rank's rows of the global td (`rank_rows`), and
    the running max is max-reduced over the group once, at the end of
    the round. The stats (reward_sum, goals, collisions, episodes,
    buffer) are summed over the group by one all_reduce before the
    round's one read of the card; the metrics are the agent's averages.
    `draws` then holds the rank's local indices and the global noise, and
    with faults the rank's own fault draws."""
    collect = make_collect_fn(agent, consts, chunk, l_scale, a_scale,
                              max_action=max_action, stride=stride,
                              frame_stack=frame_stack,
                              fault_knobs=fault_knobs, aug_prob=aug_prob)
    keys = (GUIDED_METRICS if guided else
            PER_METRICS if prioritized else PLAIN_METRICS) + (
        ("skipped_nonfinite",) if agent.nan_guard else ())
    dev = consts.device

    def one_round(state, env_carry, ring, r, expert, d, per):
        mesh = agent._mesh()              # None without grad_axis
        world = 1 if mesh is None else mesh.data
        gen = generator(step_key(seed, r), dev)
        fault_gen = generator(step_key(step_key(seed, r), FAULT_FOLD), dev)
        env_carry, traj = collect(
            state.actor, env_carry, gen,
            None if d is None else d["act_noise"], fault_gen,
            None if d is None else d.get("fault"))
        rows = {f: traj[f].reshape((-1,) + traj[f].shape[2:])
                for f in RING_FIELDS}
        if prioritized:
            per_on_write(per, ring_rows(ring, rows["obs"].shape[0]))
        ring_write(ring, rows)
        size = ring.size
        metrics = None
        if size >= batch_size:
            for u in range(updates_per_round):
                noise = None if d is None else d["update_noise"][u]
                if prioritized:
                    idx, w = per_sample(per, gen, batch_size, size, beta,
                                        u=None if d is None
                                        else d["per_u"][u])
                    batch = ring_gather(ring, idx)
                else:
                    batch = (ring_sample(ring, gen, batch_size) if d is None
                             else ring_gather(ring, d["ring_idx"][u]))
                if guided:
                    n_total = expert["obs"].shape[0]
                    eidx = (d["expert_idx"][u] if d is not None else
                            torch.randint(0, n_total, (batch_size,),
                                          generator=gen, device=dev))
                    batch["engage"] = torch.zeros_like(batch["done"])
                    eb = {k: v[eidx] for k, v in expert.items()}
                    n_exp = expert_rows(n_total, size * world,
                                        batch_size * world)
                    if prioritized:
                        state, metrics, td = agent.learn_guidence_per(
                            state, batch, eb, n_exp, w, noise=noise)
                    else:
                        state, metrics = agent.learn_guidence(
                            state, batch, eb, n_exp, noise=noise)
                elif prioritized:
                    state, metrics, td = agent.learn_per(state, batch, w,
                                                         noise=noise)
                else:
                    state, metrics = agent.learn(state, batch, noise=noise)
                if prioritized:
                    if mesh is not None:
                        td = rank_rows(td, mesh.rank, batch_size)
                    per_update(per, idx, td.abs() + 1e-6)
        if prioritized and mesh is not None:
            group_reduce(per.max_p, mesh, "max")
        on_card = [traj["rew"].sum(), traj["target"].sum(),
                   traj["collided"].sum(), traj["episode_end"].sum()]
        names = ROUND_STATS
        if mesh is not None:
            # the group's sums, the ring rows among them (JAX's psum)
            on_card = list(group_reduce(torch.stack(
                [v.float() for v in on_card]
                + [torch.full((), float(size), device=dev)]), mesh).unbind())
            names += ("buffer",)
        learnt = tuple(k for k in keys if k != "skipped_nonfinite")
        if metrics is not None:
            on_card += [metrics[k] for k in learnt]
        stats = dict.fromkeys(keys, 0.0)
        stats["buffer"] = float(size)
        # the round's one read of the card (zip stops at the round's stats
        # when no update ran)
        stats.update(zip(names + learnt, torch.stack(
            [v.float() for v in on_card]).cpu().tolist()))
        if metrics is not None and agent.nan_guard:
            stats["skipped_nonfinite"] = float(metrics["skipped_nonfinite"])
        return state, env_carry, stats

    def run(state: SACState, env_carry, ring: DeviceRing,
            rounds: Iterable[int], expert: Optional[Dict] = None,
            draws: Optional[Sequence[Dict]] = None,
            per: Optional[DevicePER] = None):
        if guided and expert is None:
            raise ValueError("this round was built with guided=True; pass "
                             "the staged expert corpus")
        if prioritized and per is None:
            raise ValueError("this round was built with prioritized=True; "
                             "pass the ring's DevicePER")
        rows = []
        for i, r in enumerate(rounds):
            state, env_carry, st = one_round(
                state, env_carry, ring, int(r), expert,
                None if draws is None else draws[i], per)
            rows.append(st)
        stats = {k: np.asarray([row[k] for row in rows], np.float32)
                 for k in (rows[0] if rows else {})}
        if prioritized:
            return state, env_carry, ring, stats, per
        return state, env_carry, ring, stats

    return run


def stage_expert(data: Dict[str, np.ndarray], frame_stack: int,
                 device) -> Dict[str, torch.Tensor]:
    """A demo corpus (`train_rl.load_expert_dataset`) as tensors on the
    device, once: frames to (N, H, W), or (N, C, H, W) stacks in channels
    mode, the goal's first two columns, rew and done as (N, 1)."""
    def frames(a):
        if frame_stack:
            return (a.transpose(0, 3, 1, 2) if a.ndim == 4
                    else np.repeat(a[:, None], frame_stack, axis=1))
        return a[..., 0] if a.ndim == 4 else a

    n = data["obs"].shape[0]
    host = {"obs": frames(data["obs"]), "act": data["act"],
            "pobs": data["goal"][:, :2], "next_pobs": data["next_goal"][:, :2],
            "rew": np.resize(data["reward"], (n, 1)),
            "next_obs": frames(data["next_obs"]),
            "done": data["done"].reshape(n, 1)}
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32),
                               device=device) for k, v in host.items()}


def train_fused(cfg: Config, out_dir: str = "results", n_envs: int = 16,
                chunk: int = 64, rounds: int = 100,
                rounds_per_dispatch: int = 10,
                updates_per_round: Optional[int] = None,
                ring_capacity: Optional[int] = None,
                world: Optional[str] = None,
                max_episodes: Optional[int] = None,
                resume: bool = False,
                expert_glob: Optional[str] = None,
                ring_snapshot_every: int = 20,
                fault_knobs: Optional[dict] = None,
                aug_prob: float = 1.0,
                world_assign: str = "reset",
                dead_segments_abort: int = 8,
                device: Optional[Union[str, torch.device]] = None) -> dict:
    """Run `rounds` rounds in segments of `rounds_per_dispatch`, logging
    each round's stats to a JSONL and checkpointing the train state after
    each segment. The name is the JAX loop's, where a segment is one
    dispatch of a `lax.scan`; here every round is dispatched from Python,
    so `rounds_per_dispatch` sets only the checkpoint cadence (and, with
    `ring_snapshot_every`, the ring snapshot's) and how often
    `max_episodes` and the dead-run detector are checked.
    `updates_per_round` defaults to one per collected env step; the ring
    holds `ring_capacity` rows (default min(sac.buffer_size, 8192)).
    `max_episodes` stops the run, checked between segments, once that
    many lane-episodes ended (`rounds` then caps it).

    `expert_glob` with train.pre_buffer: the demo corpus goes to the
    device once and every update is the guided one. sac.prioritized_replay:
    the ring's priorities live on the device beside it (the result's
    'per'; None without PER). `fault_knobs` and `aug_prob`: collection
    acts on and stores frames perturbed by `envs/fault_aug`
    (`make_collect_fn`).

    `resume`: the newest train-state checkpoint, the round, goal,
    collision and episode counters from the run's JSONL, and the ring from
    `ring_latest.npz` (written every `ring_snapshot_every` segments, and
    at the end; 0 disables it) when its geometry matches, its rows at the
    max priority under PER. Lanes restart: episodes in flight were never
    counted.

    A dead run, where every round of `dead_segments_abort` segments in a
    row ended on an update that sac.nan_guard rolled back, stops. Runs on
    the card unless device='cpu'."""
    t, e, s = cfg.train, cfg.env, cfg.sac
    fs = frame_stack_depth(cfg, "train_fused")
    ih, iw = cfg.model.image_size
    agent = SACAgent(cfg, device=device, seed=t.seed)
    state = agent.init_state(t.seed)
    dev = agent.device
    if t.pre_train and t.pre_train_model:
        d, f = os.path.split(t.pre_train_model)
        state = agent.load(state, f, d or ".", actor_only=True)

    consts = make_consts(world=world or "rrc", image_hw=(ih, iw),
                         max_steps=e.max_steps, seed=t.seed,
                         world_assign=world_assign, device=dev)
    upr = n_envs * chunk if updates_per_round is None else updates_per_round
    cap = ring_capacity or min(s.buffer_size, 8192)
    expert = None
    if t.pre_buffer and expert_glob:
        from dgvit_tpu_torch.train.train_rl import load_expert_dataset
        data = load_expert_dataset(expert_glob)
        if data is not None:
            expert = stage_expert(data, fs, dev)
            print(f"[train_fused] expert corpus on the device: "
                  f"{expert['obs'].shape[0]} transitions", flush=True)
    prioritized = bool(s.prioritized_replay)
    run = make_fused_round(agent, consts, n_envs, chunk, upr, s.batch_size,
                           l_scale=e.linear_cmd_scale,
                           a_scale=e.angular_cmd_scale,
                           max_action=e.max_action,
                           prioritized=prioritized,
                           frame_stack=fs, guided=expert is not None,
                           fault_knobs=fault_knobs, aug_prob=aug_prob,
                           seed=t.seed)
    if fault_knobs:
        print(f"[train_fused] sensor-fault augmentation: {fault_knobs} "
              f"(prob {aug_prob})", flush=True)
    env_carry = vec_reset(consts, n_envs)
    if fs:
        env_carry = (env_carry[0], stack_init(env_carry[1], fs),
                     env_carry[2])
    ring = ring_init(cap, (fs, ih, iw) if fs else (ih, iw),
                     pdim=s.pstate_dim, device=dev)
    per = per_init(cap, dev) if prioritized else None

    logger = MetricsLogger(out_dir, f"train_fused_{cfg.model.name}_{t.desc}")
    ckpt_dir = os.path.join(out_dir, t.checkpoint_dir)
    ring_path = os.path.join(ckpt_dir, "ring_latest.npz")
    done_rounds = goals = collisions = episodes = 0
    dead_segments = 0   # segments in a row whose every round's last
    #                     update was rolled back by nan_guard
    aborted_dead = False
    if resume:
        latest = ckpt.latest_checkpoint(ckpt_dir)
        if latest is not None:
            state = ckpt.restore_train_state(latest, state)
            print(f"[train_fused] resumed train state from {latest} "
                  f"(itera={state.itera})", flush=True)
        if os.path.exists(ring_path):
            if ring_load(ring_path, ring) is None:
                print("[train_fused] ring snapshot geometry mismatch: "
                      "cold-buffer resume", flush=True)
            else:
                if prioritized:
                    # priorities are not saved: the restored rows come
                    # back at the max priority (cpprb's load_transitions)
                    per_on_write(per, torch.arange(ring.size, device=dev))
                print(f"[train_fused] warm ring: {ring.size} transitions "
                      f"restored", flush=True)
        last = logger.last()
        if last:
            done_rounds, goals, collisions, episodes = (
                int(last.get(k, 0)) for k in
                ("step", "goals", "collisions", "episodes"))
            print(f"[train_fused] resumed counters: rounds={done_rounds}"
                  f" episodes={episodes} goals={goals}", flush=True)
    while done_rounds < rounds:
        seg = min(rounds_per_dispatch, rounds - done_rounds)
        state, env_carry, ring, host, *_ = run(
            state, env_carry, ring, range(done_rounds, done_rounds + seg),
            expert, per=per)
        for i in range(seg):
            done_rounds += 1
            goals += int(host["goals"][i])
            collisions += int(host["collisions"][i])
            episodes += int(host["episodes"][i])
            logger.log(done_rounds,
                       env_steps=done_rounds * n_envs * chunk,
                       goals=goals, collisions=collisions, episodes=episodes,
                       **{k: float(host[k][i]) for k in
                          ("reward_sum", "qf1_loss", "policy_loss", "alpha",
                           "buffer")})
        if t.save:
            ckpt.save_train_state(ckpt_dir, int(state.itera), state)
            ckpt.prune_checkpoints(ckpt_dir, keep=3)
            segments_done = -(-done_rounds // rounds_per_dispatch)
            if (ring_snapshot_every
                    and segments_done % ring_snapshot_every == 0):
                ring_save(ring, ring_path)
        if max_episodes is not None and episodes >= max_episodes:
            break
        skipped = host.get("skipped_nonfinite")
        if (dead_segments_abort and skipped is not None and skipped.size
                and (skipped >= 1.0).all()):
            dead_segments += 1
            if dead_segments >= dead_segments_abort:
                aborted_dead = True
                print(f"[train_fused] dead run: every round's last update "
                      f"was rolled back by nan_guard for {dead_segments} "
                      f"segments in a row; stopping at round {done_rounds}",
                      flush=True)
                break
        else:
            dead_segments = 0
    if t.save and ring_snapshot_every:
        # a final snapshot, so a resume right after is warm
        ring_save(ring, ring_path)
    return {"rounds": done_rounds, "env_steps": done_rounds * n_envs * chunk,
            "goals": goals, "collisions": collisions, "episodes": episodes,
            "updates": int(state.itera), "state": state, "ring": ring,
            "per": per, "aborted_dead": aborted_dead}


def parse_aug(p: argparse.ArgumentParser,
              items: Optional[Sequence[str]]) -> Optional[Dict[str, float]]:
    """--aug KNOB=VALUE flags -> {knob: value}, or None without any; a
    malformed item is a usage error of `p`."""
    if not items:
        return None
    knobs = {}
    for kv in items:
        k, sep, v = kv.partition("=")
        if not sep or not v:
            p.error(f"--aug expects KNOB=VALUE, got {kv!r}")
        knobs[k.strip()] = float(v)
    return knobs


def main(argv=None):
    p = argparse.ArgumentParser(
        description="dgvit_tpu_torch on-device RL training (PyTorch/CUDA)")
    p.add_argument("--config", default=None)
    p.add_argument("--out", default="results")
    p.add_argument("--n-envs", type=int, default=16)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--rounds-per-dispatch", type=int, default=10,
                   help="rounds a segment: a checkpoint after each (the "
                        "JAX loop's name; every round is dispatched from "
                        "Python here)")
    p.add_argument("--updates-per-round", type=int, default=None)
    p.add_argument("--ring-capacity", type=int, default=None)
    p.add_argument("--world", default="rrc")
    p.add_argument("--max-episodes", type=int, default=None,
                   help="stop once this many lane-episodes ended; --rounds "
                        "caps the run")
    p.add_argument("--resume", action="store_true",
                   help="restore the newest checkpoint, the JSONL counters "
                        "and the ring snapshot")
    p.add_argument("--expert-glob", default=None,
                   help="demo npz glob for the guided update (needs "
                        "train.pre_buffer)")
    p.add_argument("--ring-snapshot-every", type=int, default=20,
                   help="snapshot the ring to ring_latest.npz every N "
                        "segments for a warm --resume (0: never; 1.3 GB at "
                        "8192 rows of 128x160)")
    p.add_argument("--aug", action="append", default=None,
                   metavar="KNOB=VALUE",
                   help="sensor-fault augmentation knob (repeatable), e.g. "
                        "--aug patch_occlusion=0.25 --aug obs_noise=0.196; "
                        "knobs: obs_noise blur occlusion patch_occlusion "
                        "greying (envs/fault_aug.py)")
    p.add_argument("--aug-prob", type=float, default=1.0,
                   help="probability that a lane's frame at a step takes "
                        "the --aug knobs (1.0: every frame)")
    p.add_argument("--world-assign", choices=("reset", "lane"),
                   default="reset",
                   help="ensemble worlds: 'reset' draws a lane's world anew "
                        "each episode, 'lane' keeps lane i on world i %% K")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain PyTorch path; default: CUDA")
    args = p.parse_args(argv)
    fault_knobs = parse_aug(p, args.aug)
    cfg = Config.from_yaml(args.config) if args.config else Config()
    out = train_fused(cfg, out_dir=args.out, n_envs=args.n_envs,
                      chunk=args.chunk, rounds=args.rounds,
                      rounds_per_dispatch=args.rounds_per_dispatch,
                      updates_per_round=args.updates_per_round,
                      ring_capacity=args.ring_capacity, world=args.world,
                      max_episodes=args.max_episodes, resume=args.resume,
                      expert_glob=args.expert_glob,
                      ring_snapshot_every=args.ring_snapshot_every,
                      fault_knobs=fault_knobs, aug_prob=args.aug_prob,
                      world_assign=args.world_assign, device=args.device)
    print(f"rounds: {out['rounds']}  env steps: {out['env_steps']}  "
          f"episodes: {out['episodes']}  goals: {out['goals']}  "
          f"collisions: {out['collisions']}  updates: {out['updates']}")


if __name__ == "__main__":
    main()
