"""SAC agent: the plain update of the JAX package's `agents/sac.py::learn`.

The state (`SACState`) holds the actor, the twin-Q critic and its target
as modules with fp32 parameters, one torch Adam (eps 1e-8) each for the
actor, the critic and log_alpha, the update counter `itera`, and the
`torch.Generator` that draws every dropout mask and action noise. `learn`
updates it in place.

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
(`models/got.py`). Not here: the PER, guided and BC flavors, DrQ
augmentation and `critic_latent_reuse`.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dgvit_tpu_torch.core import checkpoint as ckpt
from dgvit_tpu_torch.core.device import resolve_device
from dgvit_tpu_torch.models import distributions
from dgvit_tpu_torch.models.jax_io import params_from_jax, params_to_jax
from dgvit_tpu_torch.models.policies import (GoTPolicy, GoTQNetwork,
                                             build_actor, build_critic)
from dgvit_tpu_torch.replay.staging import HostStager

BATCH_KEYS = ("obs", "pobs", "act", "rew", "next_obs", "next_pobs")


@dataclass
class SACState:
    actor: GoTPolicy
    critic: GoTQNetwork
    critic_target: GoTQNetwork
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    log_alpha: torch.Tensor         # fp32 scalar, the auto-tuned temperature
    alpha_opt: torch.optim.Adam
    itera: int                      # update counter
    generator: torch.Generator      # dropout masks and action noise


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
        self.obs_ndim = 3 if cfg.model.patch_mode == "channels" else 2
        self._act_stager = None     # pinned buffers of choose_action_host

    def init_state(self, seed: Optional[int] = None) -> SACState:
        seed = self.seed if seed is None else int(seed)
        g = torch.Generator().manual_seed(seed)
        actor = build_actor(self.cfg, self.dtype, g).to(self.device)
        critic = build_critic(self.cfg, self.dtype, g).to(self.device)
        target = copy.deepcopy(critic).requires_grad_(False)
        log_alpha = torch.tensor(math.log(self.cfg.sac.alpha),
                                 dtype=torch.float32, device=self.device,
                                 requires_grad=True)
        s = self.cfg.sac
        adam = lambda params, lr: torch.optim.Adam(params, lr=lr, eps=1e-8)
        return SACState(
            actor=actor, critic=critic, critic_target=target,
            actor_opt=adam(actor.parameters(), s.lr_actor),
            critic_opt=adam(critic.parameters(), s.lr_critic),
            log_alpha=log_alpha, alpha_opt=adam([log_alpha], s.lr_alpha),
            itera=0,
            generator=torch.Generator(self.device).manual_seed(seed))

    # ------------------------------------------------------------------
    # acting
    # ------------------------------------------------------------------
    @torch.no_grad()
    def act_batch(self, actor: GoTPolicy, obs, pobs,
                  generator: Optional[torch.Generator] = None,
                  evaluate: bool = False) -> torch.Tensor:
        """Batched action of an actor, no dropout, through the whole-trunk
        kernel: tanh(mean) with evaluate, else a sample (noise from
        `generator`)."""
        o, p = (x if isinstance(x, torch.Tensor) else
                torch.as_tensor(np.asarray(x, np.float32), device=self.device)
                for x in (obs, pobs))
        mean, log_std = actor(o, p, inference=True)
        if evaluate:
            return torch.tanh(mean)
        return distributions.sample(mean, log_std, generator).action

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

    def learn(self, state: SACState, batch: Mapping[str, object],
              noise: Optional[Sequence] = None
              ) -> Tuple[SACState, Dict[str, torch.Tensor]]:
        """One SAC update (DRL.py:373-437), in place.

        batch: obs (B, H, W), pobs (B, pstate), act (B, A), rew (B,) or
        (B, 1), next_obs, next_pobs, and done when the done mask is on;
        numpy or tensors. noise: optional (next-action, policy) standard
        normal draws, each (B, A), in place of the generator's. Returns the
        state and the metrics (0-dim tensors)."""
        keys = BATCH_KEYS + (("done",) if self.done_mask else ())
        b = {k: torch.as_tensor(batch[k], dtype=torch.float32,
                                device=self.device) for k in keys}
        noise_next, noise_pi = (None, None) if noise is None else (
            torch.as_tensor(n, dtype=torch.float32, device=self.device)
            for n in noise)
        g = state.generator
        prev = self._snapshot(state) if self.nan_guard else None
        alpha = self._alpha(state)

        # TD target: no-grad forwards with live dropout (K4 route)
        with torch.no_grad():
            mean, log_std = state.actor(b["next_obs"], b["next_pobs"],
                                        deterministic=False, inference=True,
                                        generator=g)
            nxt = distributions.sample(mean, log_std, g, noise=noise_next)
            q1_t, q2_t = state.critic_target(
                b["next_obs"], b["next_pobs"], nxt.action,
                deterministic=False, inference=True, generator=g)
            min_q = torch.minimum(q1_t, q2_t).float() \
                - alpha * nxt.log_prob.float()
            rew = b["rew"].reshape(-1, 1)
            if self.done_mask:
                min_q = (1.0 - b["done"].reshape(-1, 1)) * min_q
            target = rew + self.gamma * min_q

        # critic update (K2/K3 route)
        q1, q2 = state.critic(b["obs"], b["pobs"], b["act"],
                              deterministic=False, generator=g)
        qf1_loss = torch.mean(torch.square(q1.float() - target))
        qf2_loss = torch.mean(torch.square(q2.float() - target))
        state.critic_opt.zero_grad(set_to_none=True)
        (qf1_loss + qf2_loss).backward()
        state.critic_opt.step()

        # actor update against the updated critic; its trunk is no-grad
        mean, log_std = state.actor(b["obs"], b["pobs"], deterministic=False,
                                    generator=g)
        s = distributions.sample(mean, log_std, g, noise=noise_pi)
        with torch.no_grad():
            latent = state.critic.trunk(b["obs"], b["pobs"],
                                        deterministic=False, inference=True,
                                        generator=g)
        q1_pi, q2_pi = state.critic.heads(latent, s.action)
        min_q_pi = torch.minimum(q1_pi, q2_pi).float()
        policy_loss = torch.mean(alpha * s.log_prob.float() - min_q_pi)
        params = list(state.actor.parameters())
        grads = torch.autograd.grad(policy_loss, params)
        for p, gr in zip(params, grads):
            p.grad = gr
        state.actor_opt.step()

        # temperature
        log_pi = s.log_prob.detach().float()
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

        metrics = {"qf1_loss": qf1_loss.detach(),
                   "qf2_loss": qf2_loss.detach(),
                   "policy_loss": policy_loss.detach(),
                   "alpha_loss": alpha_loss, "alpha": alpha,
                   "entropy": -torch.mean(log_pi)}
        if self.nan_guard:
            ok = bool(torch.isfinite(metrics["qf1_loss"] + metrics["qf2_loss"])
                      & torch.isfinite(metrics["policy_loss"]))
            if not ok:
                self._restore(state, prev)
            metrics["skipped_nonfinite"] = torch.tensor(float(not ok))
        return state, metrics

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
