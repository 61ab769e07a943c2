"""SAC agent: the updates of the JAX package's `agents/sac.py`: the
plain and the expert-guided one (`learn`, `learn_guidence`) and their
prioritized-replay flavours (`learn_per`, `learn_guidence_per`).

The state (`SACState`) holds the actor, the twin-Q critic and its target
as modules with fp32 parameters, one torch Adam (eps 1e-8) each for the
actor, the critic and log_alpha, the update counter `itera`, and the
`torch.Generator` that draws every dropout mask and action noise, and,
with `sac.aug_shift`, a second generator for the DrQ shifts' offsets.
`learn` updates it in place.

Replicated reference semantics (sac.py:9-36), each deliberate:
  * TD target r + gamma * (minQ' - alpha * logpi') with no done mask
    (`sac.done_mask_in_target` opts into the mask);
  * the Q nets output `action_dim` values, and the (B, 1) reward
    broadcasts against the (B, 2) minQ;
  * the step uses the previous step's alpha; log_alpha updates after the
    actor loss;
  * the actor loss is taken against the already-updated critic;
  * Polyak averaging of the target when itera % policy_freq == 0, before
    itera advances;
  * `sac.alpha_max` / `sac.alpha_min` clamp the auto-tuned temperature;
  * with `sac.nan_guard`, an update whose losses are not finite is rolled
    back whole, and itera advances anyway.
Emb-dropout stays live in every learn forward, as the reference never
calls .eval(). The no-grad forwards (the TD target's actor and target
critic, and the critic trunk in the actor step) take the K4 route; the
critic and actor losses differentiate through the K2/K3 route
(`models/got.py`).

`learn_guidence` (DRL.py learn_guidence; JAX `_guided_core`) runs the
same update on the agent rows merged with an expert batch (2B rows): the
TD target, the critic loss and the policy loss over the merged rows,
weighted 1 on agent rows and by validity (`row < n_expert`) on expert
rows, plus a behaviour-cloning loss of the deterministic actor on the
valid expert rows (`guidence_weight`, with its geometric curriculum) and
an intervention loss on the agent rows with engage == 1
(`engage_weight`).

The PER flavours (JAX `_per_step_impl`, `_guided_per_step_impl`) take the
buffer's importance weights and return the per-row |TD error| of the
first Q head for the priority update: `learn_per` weights the critic loss
mean(w (q - target)^2); `learn_guidence_per` weights the agent rows of
the guided update's critic and policy losses by them. Under
`sac.nan_guard` a rolled-back or non-finite row reports the batch's mean
finite |TD error| (1 when none is finite), computed on the device.

DrQ (`sac.aug_shift`, JAX `_augment`): obs and next_obs of the batch,
and the expert's on the guided path, are shifted independently
(`ops/augment.random_shift`) before the losses see them, except in the
first `sac.aug_warmup` updates; with `sac.aug_actor` False the actor step
(the policy forward, its Q evaluation and the guided BC losses) sees the
raw frames. The offsets come from the state's `aug_generator`, so the
dropout masks and action noise of an update are those of the same update
without the shift. Not here: `critic_latent_reuse`.

Every actor and critic of the zoo (`models/policies.py`) runs these
updates, as in the JAX package:
  * the actor step evaluates the updated critic with its parameters
    frozen: the GoT critic as its no-grad trunk (K4) and its heads, any
    other critic whole (JAX sac.py:449-453);
  * a deterministic actor (`Deterministic*`) has alpha 0 and no
    temperature step (JAX sac.py:171-174), explores with
    `distributions.deterministic_sample` (mean plus clip(N(0, 1) x 0.1,
    +-0.25), log_prob 0) and acts with its own squashed output;
  * `train.policy_attention_fix` / `critic_attention_fix` (the
    reference's P_ATTENTION_FIX / C_ATTENTION_FIX; the Transformer actors
    and the Transformer critic only) freeze `trans` and `fc_embed`: their
    parameters stop requiring gradients and the Adam holds the heads
    alone, as optax.multi_transform with set_to_zero gives them
    exactly-zero updates and no optimizer state in JAX;
  * the `Deterministic` actor (a 4-channel CNN on (B, H, W, 4) frame
    stacks) raises by name: the JAX package's init_state builds the critic
    beside it for single frames, which its own update cannot feed, and no
    env loop builds such stacks.
"""

from __future__ import annotations

import contextlib
import copy
import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.core.device import resolve_device
from dgvit_tpu_torch.core.rng import generator, step_key
from dgvit_tpu_torch.models import distributions
from dgvit_tpu_torch.models.jax_io import params_from_jax, params_to_jax
from dgvit_tpu_torch.models.policies import (GoTQNetwork, build_actor,
                                             build_critic)
from dgvit_tpu_torch.ops.augment import random_shift
from dgvit_tpu_torch.replay.staging import HostStager

BATCH_KEYS = ("obs", "pobs", "act", "rew", "next_obs", "next_pobs")
GUIDED_KEYS = BATCH_KEYS + ("done",)
PLAIN_METRICS = ("qf1_loss", "qf2_loss", "policy_loss", "alpha_loss",
                 "alpha", "entropy")
PER_METRICS = PLAIN_METRICS[:-1]
AUG_STREAM = 0xD7   # step_key tag of the shift offsets' generator
FROZEN = ("trans", "fc_embed")   # what head-only fine-tuning keeps fixed


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """The module's parameters stop requiring gradients inside the block
    (each flag restored after it)."""
    params = list(module.parameters())
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield module
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


@dataclass
class SACState:
    actor: torch.nn.Module          # any actor of models/policies.py
    critic: torch.nn.Module
    critic_target: torch.nn.Module
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    log_alpha: torch.Tensor         # fp32 scalar, the auto-tuned temperature
    alpha_opt: torch.optim.Adam
    itera: int                      # update counter
    generator: torch.Generator      # dropout masks and action noise
    # the DrQ shifts' offsets (sac.aug_shift > 0), else None
    aug_generator: Optional[torch.Generator] = None


class SACAgent:
    """Builds the modules and optimizers; runs the update and acting.

    dtype: the compute dtype (None: bf16 when `model.compute_dtype` says
    so, else fp32); parameters stay fp32. device: CUDA unless 'cpu'.
    seed: initial parameters and the generator of `init_state`."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        if dtype is None and cfg.model.compute_dtype == "bfloat16":
            dtype = torch.bfloat16
        self.dtype = dtype
        self.seed = int(seed)
        s = cfg.sac
        self.gamma = float(s.gamma)
        self.tau = float(s.tau)
        self.policy_freq = int(s.policy_freq)
        self.target_entropy = -float(s.action_dim)
        self.auto_tune = bool(s.auto_tune_alpha)
        self.fixed_alpha = float(s.alpha)
        self.alpha_max, self.alpha_min = s.alpha_max, s.alpha_min
        self.done_mask = bool(s.done_mask_in_target)
        self.nan_guard = bool(s.nan_guard)
        self.guidence_weight = float(s.guidence_weight)
        self.engage_weight = float(s.engage_weight)
        self.gw_final = (None if s.guidence_weight_final is None
                         else float(s.guidence_weight_final))
        self.gw_decay_steps = int(s.guidence_decay_steps or 0)
        m = cfg.model
        if m.actor_type == "Deterministic":
            raise NotImplementedError(
                "SACAgent: the Deterministic (4-channel CNN) actor takes "
                "(H, W, 4) frame stacks, while the critic is built for "
                "single frames and no env loop builds such stacks (the JAX "
                "package's update fails on this family)")
        # unbatched observation rank: (C, H, W) in channels mode, else (H, W)
        self.obs_ndim = 3 if m.patch_mode == "channels" else 2
        self.deterministic_actor = m.actor_type.startswith("Deterministic")
        if self.deterministic_actor:
            self.auto_tune, self.fixed_alpha = False, 0.0
        tcfg = cfg.train
        self.actor_fix = (tcfg.policy_attention_fix
                          and m.actor_type.endswith("Transformer"))
        self.critic_fix = (tcfg.critic_attention_fix
                           and m.critic_type == "Transformer")
        self.aug_shift = int(s.aug_shift)
        self.aug_actor = bool(s.aug_actor)
        self.aug_warmup = int(s.aug_warmup)
        self._act_stager = None     # pinned buffers of choose_action_host

    def init_state(self, seed: Optional[int] = None) -> SACState:
        seed = self.seed if seed is None else int(seed)
        g = torch.Generator().manual_seed(seed)
        actor = build_actor(self.cfg, self.dtype, g).to(self.device)
        critic = build_critic(self.cfg, self.dtype, g).to(self.device)
        target = copy.deepcopy(critic).requires_grad_(False)
        for module, fix in ((actor, self.actor_fix),
                            (critic, self.critic_fix)):
            if fix:
                for name in FROZEN:
                    getattr(module, name).requires_grad_(False)
        trainable = lambda module: [p for p in module.parameters()
                                    if p.requires_grad]
        log_alpha = torch.tensor(math.log(self.cfg.sac.alpha),
                                 dtype=torch.float32, device=self.device,
                                 requires_grad=True)
        s = self.cfg.sac
        adam = lambda params, lr: torch.optim.Adam(params, lr=lr, eps=1e-8)
        return SACState(
            actor=actor, critic=critic, critic_target=target,
            actor_opt=adam(trainable(actor), s.lr_actor),
            critic_opt=adam(trainable(critic), s.lr_critic),
            log_alpha=log_alpha, alpha_opt=adam([log_alpha], s.lr_alpha),
            itera=0,
            generator=torch.Generator(self.device).manual_seed(seed),
            aug_generator=(generator(step_key(seed, AUG_STREAM), self.device)
                           if self.aug_shift else None))

    # ------------------------------------------------------------------
    # acting
    # ------------------------------------------------------------------
    @torch.no_grad()
    def act_batch(self, actor: torch.nn.Module, obs, pobs,
                  generator: Optional[torch.Generator] = None,
                  evaluate: bool = False,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Batched action of an actor, no dropout (a GoT trunk through the
        whole-trunk kernel): the deterministic action with evaluate
        (tanh(mean), or a deterministic actor's own output), else a
        sample (noise from `generator`, or the standard normal draws
        `noise` (B, A))."""
        o, p = (x if isinstance(x, torch.Tensor) else
                torch.as_tensor(np.asarray(x, np.float32), device=self.device)
                for x in (obs, pobs))
        s = self._sample(actor, o, p, generator, noise, inference=True)
        return s.mean if evaluate else s.action

    def _sample(self, actor: torch.nn.Module, obs, pobs,
                generator: Optional[torch.Generator],
                noise: Optional[torch.Tensor] = None, **kw
                ) -> distributions.TanhGaussianSample:
        """The actor's forward (keywords `kw` to it, its dropout from
        `generator`) and its sample: the tanh-Gaussian one, or a
        deterministic actor's exploration."""
        out = actor(obs, pobs, generator=generator, **kw)
        if self.deterministic_actor:
            return distributions.deterministic_sample(out, generator,
                                                      noise=noise)
        return distributions.sample(out[0], out[1], generator, noise=noise)

    def mean_action(self, actor: torch.nn.Module, obs, pobs
                    ) -> torch.Tensor:
        """The deterministic action, no dropout, with autograd: tanh(mean)
        or a deterministic actor's own output."""
        out = actor(obs, pobs, deterministic=True)
        return out if self.deterministic_actor else torch.tanh(out[0])

    def choose_action(self, state: SACState, obs, pobs,
                      evaluate: bool = False) -> torch.Tensor:
        """Single- or batched-state action; an unbatched input gets a batch
        dim added and squeezed back."""
        obs = np.asarray(obs, np.float32)
        pobs = np.asarray(pobs, np.float32)
        squeeze = obs.ndim == self.obs_ndim
        if squeeze:
            obs, pobs = obs[None], pobs[None]
        a = self.act_batch(state.actor, obs, pobs, state.generator, evaluate)
        return a[0] if squeeze else a

    def choose_action_host(self, state: SACState, obs, pobs,
                           evaluate: bool = False) -> np.ndarray:
        """One state's action as a numpy array: the env loop's acting
        call. On the card the frame and the goal go up through pinned
        staging buffers that are reused, and the host waits once, for the
        action."""
        if self._act_stager is None:
            self._act_stager = HostStager(self.device)
        dev, _ = self._act_stager.put(
            {"obs": np.asarray(obs, np.float32)[None],
             "pobs": np.asarray(pobs, np.float32)[None]})
        a = self.act_batch(state.actor, dev["obs"], dev["pobs"],
                           state.generator, evaluate)
        return a[0].float().cpu().numpy()

    # ------------------------------------------------------------------
    # the update
    # ------------------------------------------------------------------
    def _alpha(self, state: SACState) -> torch.Tensor:
        if self.auto_tune:
            return state.log_alpha.detach().exp()
        return torch.tensor(self.fixed_alpha, device=self.device)

    def _tensors(self, batch: Mapping[str, object], keys) -> Dict:
        return {k: torch.as_tensor(batch[k], dtype=torch.float32,
                                   device=self.device) for k in keys}

    def _noise(self, noise):
        return (None, None) if noise is None else tuple(
            torch.as_tensor(n, dtype=torch.float32, device=self.device)
            for n in noise)

    @torch.no_grad()
    def _td_target(self, state: SACState, alpha, b, noise_next):
        """r + gamma * (minQ' - alpha logpi'): no-grad forwards with live
        dropout (K4 route)."""
        g = state.generator
        nxt = self._sample(state.actor, b["next_obs"], b["next_pobs"], g,
                           noise_next, deterministic=False, inference=True)
        q1_t, q2_t = state.critic_target(
            b["next_obs"], b["next_pobs"], nxt.action,
            deterministic=False, inference=True, generator=g)
        min_q = torch.minimum(q1_t, q2_t).float() \
            - alpha * nxt.log_prob.float()
        rew = b["rew"].reshape(-1, 1)
        if self.done_mask:
            min_q = (1.0 - b["done"].reshape(-1, 1)) * min_q
        return rew + self.gamma * min_q

    def _policy_terms(self, state: SACState, alpha, b, noise_pi):
        """The actor's sample on the batch (live dropout) and alpha logpi -
        minQ against the updated critic, its parameters frozen (the GoT
        critic's trunk no-grad, then its heads; any other critic whole):
        (sample, per-element loss (B, A))."""
        g = state.generator
        s = self._sample(state.actor, b["obs"], b["pobs"], g, noise_pi,
                         deterministic=False)
        kw = dict(deterministic=False, inference=True, generator=g)
        if isinstance(state.critic, GoTQNetwork):
            with torch.no_grad():
                latent = state.critic.trunk(b["obs"], b["pobs"], **kw)
            q1_pi, q2_pi = state.critic.heads(latent, s.action)
        else:
            with frozen(state.critic):
                q1_pi, q2_pi = state.critic(b["obs"], b["pobs"], s.action,
                                            **kw)
        min_q_pi = torch.minimum(q1_pi, q2_pi).float()
        return s, alpha * s.log_prob.float() - min_q_pi

    @staticmethod
    def _actor_step(state: SACState, loss: torch.Tensor) -> None:
        params = [p for group in state.actor_opt.param_groups
                  for p in group["params"]]
        grads = torch.autograd.grad(loss, params)
        for p, gr in zip(params, grads):
            p.grad = gr
        state.actor_opt.step()

    def _finish(self, state: SACState, log_pi: torch.Tensor, metrics: Dict,
                prev) -> Dict:
        """The temperature's step (its loss into metrics), Polyak averaging
        and the counter, then nan_guard's rollback: the tail every update
        flavour shares."""
        if self.auto_tune:
            alpha_loss = -torch.mean(state.log_alpha
                                     * (log_pi + self.target_entropy))
            state.alpha_opt.zero_grad(set_to_none=True)
            alpha_loss.backward()
            state.alpha_opt.step()
            with torch.no_grad():
                if self.alpha_max is not None:
                    state.log_alpha.copy_(torch.minimum(
                        state.log_alpha, self._log(self.alpha_max)))
                if self.alpha_min is not None:
                    state.log_alpha.copy_(torch.maximum(
                        state.log_alpha, self._log(self.alpha_min)))
            alpha_loss = alpha_loss.detach()
        else:
            alpha_loss = torch.zeros((), device=self.device)

        # Polyak, then the counter
        if state.itera % self.policy_freq == 0:
            with torch.no_grad():
                for t, p in zip(state.critic_target.parameters(),
                                state.critic.parameters()):
                    t.copy_(t * (1.0 - self.tau) + p * self.tau)
        state.itera += 1

        metrics = dict(metrics, alpha_loss=alpha_loss)
        if self.nan_guard:
            ok = bool(torch.isfinite(metrics["qf1_loss"] + metrics["qf2_loss"])
                      & torch.isfinite(metrics["policy_loss"]))
            if not ok:
                self._restore(state, prev)
            metrics["skipped_nonfinite"] = torch.tensor(float(not ok))
        return metrics

    def _augment(self, state: SACState, b: Dict, e: Optional[Dict] = None,
                 shifts: Optional[Sequence] = None):
        """(b, e) with obs and next_obs shifted (sac.aug_shift; JAX
        `_augment`), each on offsets of its own: b's obs, b's next_obs,
        then e's. Unchanged without the shift and in the first aug_warmup
        updates (the host counter gates; nothing is drawn there).
        shifts: the (B, 2) offsets in that order, in place of the
        generator's (tests)."""
        if not self.aug_shift or state.itera < self.aug_warmup:
            return b, e
        offs = iter(shifts) if shifts is not None else None

        def shift(d):
            d = dict(d)
            for k in ("obs", "next_obs"):
                d[k] = random_shift(d[k], self.aug_shift,
                                    state.aug_generator,
                                    None if offs is None else next(offs))
            return d

        b = shift(b)
        return b, (None if e is None else shift(e))

    def _plain_core(self, state: SACState, batch: Mapping[str, object],
                    weights: Optional[torch.Tensor], noise, shifts):
        """One plain update, its critic loss weighted per row by `weights`
        when given (PER): (state, metrics, td), td the per-row |TD error|
        of the first Q head with weights, else None."""
        keys = BATCH_KEYS + (("done",) if self.done_mask else ())
        clean = self._tensors(batch, keys)
        b, _ = self._augment(state, clean, shifts=shifts)
        actor_b = b if self.aug_actor else clean
        noise_next, noise_pi = self._noise(noise)
        g = state.generator
        prev = self._snapshot(state) if self.nan_guard else None
        alpha = self._alpha(state)
        target = self._td_target(state, alpha, b, noise_next)

        # critic update (K2/K3 route)
        q1, q2 = state.critic(b["obs"], b["pobs"], b["act"],
                              deterministic=False, generator=g)
        td = None
        if weights is None:
            qf1_loss = torch.mean(torch.square(q1.float() - target))
            qf2_loss = torch.mean(torch.square(q2.float() - target))
        else:
            td = torch.abs(q1.detach().float() - target).mean(dim=1)
            w = weights.reshape(-1, 1)
            qf1_loss = torch.mean(w * torch.square(q1.float() - target))
            qf2_loss = torch.mean(w * torch.square(q2.float() - target))
        state.critic_opt.zero_grad(set_to_none=True)
        (qf1_loss + qf2_loss).backward()
        state.critic_opt.step()

        # actor update against the updated critic; its trunk is no-grad
        s, per_elem = self._policy_terms(state, alpha, actor_b, noise_pi)
        policy_loss = torch.mean(per_elem)
        self._actor_step(state, policy_loss)
        log_pi = s.log_prob.detach().float()
        metrics = self._finish(state, log_pi, {
            "qf1_loss": qf1_loss.detach(), "qf2_loss": qf2_loss.detach(),
            "policy_loss": policy_loss.detach(), "alpha": alpha,
            "entropy": -torch.mean(log_pi)}, prev)
        return state, metrics, td

    def learn(self, state: SACState, batch: Mapping[str, object],
              noise: Optional[Sequence] = None,
              shifts: Optional[Sequence] = None
              ) -> Tuple[SACState, Dict[str, torch.Tensor]]:
        """One SAC update (DRL.py:373-437), in place.

        batch: obs (B, H, W), pobs (B, pstate), act (B, A), rew (B,) or
        (B, 1), next_obs, next_pobs, and done when the done mask is on;
        numpy or tensors. noise: optional (next-action, policy) standard
        normal draws, each (B, A), in place of the generator's. shifts:
        optional DrQ offsets (`_augment`). Returns the state and the
        metrics (0-dim tensors)."""
        state, metrics, _ = self._plain_core(state, batch, None, noise,
                                             shifts)
        return state, self._keep(metrics, PLAIN_METRICS)

    def learn_per(self, state: SACState, batch: Mapping[str, object],
                  is_weights, noise: Optional[Sequence] = None,
                  shifts: Optional[Sequence] = None
                  ) -> Tuple[SACState, Dict[str, torch.Tensor],
                             torch.Tensor]:
        """One PER update (JAX `_per_step_impl`), in place: `learn` with
        the critic loss mean(w (q - target)^2) for the importance weights
        `is_weights` (B,). Returns the state, the metrics (`learn`'s but
        entropy) and the per-row |TD error| (B,) on the device, for
        `update_priorities(|td| + eps)`."""
        w = torch.as_tensor(is_weights, dtype=torch.float32,
                            device=self.device)
        state, metrics, td = self._plain_core(state, batch, w, noise, shifts)
        return state, self._keep(metrics, PER_METRICS), \
            self._guard_td(td, metrics)

    def _keep(self, metrics: Dict, keys) -> Dict:
        return {k: metrics[k] for k in (
            *keys, *(("skipped_nonfinite",) if self.nan_guard else ()))}

    def _guard_td(self, td: torch.Tensor, metrics: Dict) -> torch.Tensor:
        """Under nan_guard, the scale-aware neutral |TD error| (the mean
        of the finite ones, 1 when none is) for every row of a rolled-back
        update and for each non-finite row (JAX sac.py:668-693); on the
        device, gated by the rollback's host flag."""
        if not self.nan_guard:
            return td
        finite = torch.isfinite(td)
        n_fin = finite.float().sum()
        neutral = torch.where(
            n_fin > 0, torch.where(finite, td.abs(), 0.0).sum()
            / torch.clamp(n_fin, min=1.0), 1.0)
        if float(metrics["skipped_nonfinite"]) > 0:
            return neutral.expand_as(td).clone()
        return torch.where(finite, td, neutral)

    def guidence_weight_at(self, itera: int) -> torch.Tensor:
        """The guidance-weight curriculum (JAX sac.py:783-792): geometric
        decay from sac.guidence_weight to sac.guidence_weight_final over
        sac.guidence_decay_steps updates, taken in fp32 at the update
        counter before the step; constant without a final weight."""
        w0 = self.guidence_weight
        gw = torch.tensor(w0, dtype=torch.float32, device=self.device)
        if (self.gw_final is not None and self.gw_decay_steps > 0
                and self.gw_final != w0):
            frac = torch.clamp(torch.tensor(float(itera), dtype=torch.float32,
                                            device=self.device)
                               / float(self.gw_decay_steps), 0.0, 1.0)
            ratio = torch.tensor(self.gw_final / w0, dtype=torch.float32,
                                 device=self.device)
            gw = w0 * torch.pow(ratio, frac)
        return gw

    def _bc_mse(self, state: SACState, obs, pobs, act, rows) -> torch.Tensor:
        """Masked MSE of the deterministic actor's mean action (no dropout)
        against `act` over the rows where `rows` is 1:
        sum(rows (tanh(mean) - act)^2) / max(sum(rows) A, 1)."""
        sq = torch.square(self.mean_action(state.actor, obs, pobs)
                          - act).float()
        denom = torch.clamp(torch.sum(rows) * sq.shape[1], min=1.0)
        return torch.sum(rows.reshape(-1, 1) * sq) / denom

    def _guided_core(self, state: SACState, batch, expert_batch, n_expert,
                     noise=None, agent_weights=None, shifts=None):
        """The guided update on agent ++ expert rows (JAX `_guided_core`):
        the agent rows weighted by `agent_weights` (B,) (all ones when
        None, PER's importance weights for `learn_guidence_per`), the
        expert rows by validity. (state, metrics, td), td the per-agent-row
        |TD error|."""
        clean = self._tensors(batch, GUIDED_KEYS)
        clean_e = self._tensors(expert_batch, GUIDED_KEYS)
        b, e = self._augment(state, clean, clean_e, shifts)
        engage = torch.as_tensor(batch["engage"], dtype=torch.float32,
                                 device=self.device).reshape(-1)
        noise_next, noise_pi = self._noise(noise)
        g = state.generator
        prev = self._snapshot(state) if self.nan_guard else None
        itera = state.itera
        alpha = self._alpha(state)
        rows, rows_e = b["obs"].shape[0], e["obs"].shape[0]
        n_expert = int(n_expert)
        valid = (torch.arange(rows_e, device=self.device)
                 < n_expert).float()
        merged = {k: torch.cat([b[k], e[k]], dim=0) for k in GUIDED_KEYS}
        agent_w = (torch.ones(rows, device=self.device)
                   if agent_weights is None else
                   torch.as_tensor(agent_weights, dtype=torch.float32,
                                   device=self.device).reshape(-1))
        w = torch.cat([agent_w, valid]).reshape(-1, 1)
        target = self._td_target(state, alpha, merged, noise_next)

        # critic update on the merged rows, weighted
        q1, q2 = state.critic(merged["obs"], merged["pobs"], merged["act"],
                              deterministic=False, generator=g)
        q1, q2 = q1.float(), q2.float()
        td = torch.abs(q1.detach() - target).mean(dim=1)[:rows]
        denom = torch.sum(w) * q1.shape[1]
        qf1_loss = torch.sum(w * torch.square(q1 - target)) / denom
        qf2_loss = torch.sum(w * torch.square(q2 - target)) / denom
        state.critic_opt.zero_grad(set_to_none=True)
        (qf1_loss + qf2_loss).backward()
        state.critic_opt.step()

        # actor: the weighted policy loss over the merged rows, the expert
        # BC loss and the intervention loss (both computed whatever their
        # gates, as the JAX step computes them); with aug_actor False on
        # the raw frames of the same rows
        if not self.aug_actor:
            b, e = clean, clean_e
            merged = {k: torch.cat([b[k], e[k]], dim=0) for k in GUIDED_KEYS}
        gw = self.guidence_weight_at(itera)
        s, per_elem = self._policy_terms(state, alpha, merged, noise_pi)
        policy_loss = torch.sum(w * per_elem) / (
            torch.sum(w) * per_elem.shape[1])
        bc = self._bc_mse(state, e["obs"], e["pobs"], e["act"], valid)
        eng = self._bc_mse(state, b["obs"], b["pobs"], b["act"], engage)
        policy_loss = policy_loss + (
            gw * bc * float(n_expert > 0)
            + self.engage_weight * eng * (torch.sum(engage) > 0).float())
        self._actor_step(state, policy_loss)
        metrics = self._finish(state, s.log_prob.detach().float(), {
            "qf1_loss": qf1_loss.detach(), "qf2_loss": qf2_loss.detach(),
            "policy_loss": policy_loss.detach(), "alpha": alpha,
            "n_expert": torch.tensor(float(n_expert), device=self.device),
            "guidence_weight": gw}, prev)
        return state, metrics, td

    def learn_guidence(self, state: SACState, batch: Mapping[str, object],
                       expert_batch: Mapping[str, object], n_expert: int,
                       noise: Optional[Sequence] = None,
                       shifts: Optional[Sequence] = None
                       ) -> Tuple[SACState, Dict[str, torch.Tensor]]:
        """One expert-guided SAC update (DRL.py learn_guidence), in place.

        batch: the agent rows as `learn` takes them, with done and engage
        (B,) or (B, 1); expert_batch: the expert rows (Be, ...) with the
        expert's action as 'act', the first `n_expert` valid (the rest
        mask padding). noise: optional (next-action, policy) standard
        normal draws over the merged rows, each (B + Be, A). shifts:
        optional DrQ offsets (`_augment`). Returns the state and the
        metrics, `n_expert` and `guidence_weight` among them."""
        state, metrics, _ = self._guided_core(state, batch, expert_batch,
                                              n_expert, noise, None, shifts)
        return state, metrics

    def learn_guidence_per(self, state: SACState,
                           batch: Mapping[str, object],
                           expert_batch: Mapping[str, object], n_expert: int,
                           is_weights, noise: Optional[Sequence] = None,
                           shifts: Optional[Sequence] = None):
        """The guided update with the agent rows weighted by PER's
        importance weights `is_weights` (B,) (JAX `_guided_per_step_impl`),
        in place: (state, metrics, td), td the per-agent-row |TD error|
        (B,) on the device."""
        state, metrics, td = self._guided_core(
            state, batch, expert_batch, n_expert, noise, is_weights, shifts)
        return state, metrics, self._guard_td(td, metrics)

    @staticmethod
    def expert_batch_size(exp_buffer_size: int, agent_buffer_size: int,
                          batch_size: int) -> int:
        """DRL.py:195: min(floor(exp / agent * batch), batch)."""
        if agent_buffer_size <= 0:
            return batch_size
        return int(min(np.floor(exp_buffer_size / agent_buffer_size
                                * batch_size), batch_size))

    # ------------------------------------------------------------------
    # checkpoint conveniences mirroring the DRL.py API surface
    # ------------------------------------------------------------------
    def save(self, state: SACState, filename: str, directory: str,
             reward: float, seed: int, nb_col: int = 100):
        """DRL.py:489-491: metric-encoded actor and critic exports, in the
        JAX package's flat npz layout."""
        name = ckpt.reference_name(filename, reward, seed, nb_col)
        return tuple(ckpt.save_params_npz(
            directory, name, params_to_jax(getattr(state, kind).state_dict()),
            kind=kind) for kind in ("actor", "critic"))

    def load(self, state: SACState, filename: str, directory: str,
             actor_only: bool = False) -> SACState:
        """DRL.py:493-503 load / load_actor, from flat npz files of either
        package, in place."""
        for kind in ("actor",) if actor_only else ("actor", "critic"):
            getattr(state, kind).load_state_dict(params_from_jax(
                ckpt.load_params_npz(f"{directory}/{filename}_{kind}.npz")))
        return state

    def load_target(self, state: SACState) -> SACState:
        """DRL.py:499-500 hard_update(critic_target, critic), in place."""
        state.critic_target.load_state_dict(state.critic.state_dict())
        return state

    def _log(self, x: float) -> torch.Tensor:
        """log of a clamp bound, taken in fp32 as the JAX update takes it."""
        return torch.log(torch.tensor(x, dtype=torch.float32,
                                      device=self.device))

    @staticmethod
    def _snapshot(state: SACState):
        """Everything an update changes but the counter and the generator."""
        mods = (state.actor, state.critic, state.critic_target)
        opts = (state.actor_opt, state.critic_opt, state.alpha_opt)
        return ([[p.detach().clone() for p in m.parameters()] for m in mods],
                state.log_alpha.detach().clone(),
                [copy.deepcopy(o.state_dict()) for o in opts])

    @staticmethod
    def _restore(state: SACState, snap) -> None:
        params, log_alpha, opt_states = snap
        mods = (state.actor, state.critic, state.critic_target)
        opts = (state.actor_opt, state.critic_opt, state.alpha_opt)
        with torch.no_grad():
            for m, saved in zip(mods, params):
                for p, v in zip(m.parameters(), saved):
                    p.copy_(v)
            state.log_alpha.copy_(log_alpha)
        for o, sd in zip(opts, opt_states):
            o.load_state_dict(sd)
