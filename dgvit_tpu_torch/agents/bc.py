"""Behaviour cloning: the imitation trainer of the JAX package's
`agents/bc.py` (Imitation_learning.py semantics).

  * demo corpus -> 80/20 random split (`split_80_20`);
  * shuffled minibatches, the remainder dropped;
  * loss = RMSE(clip(tanh(mean) * max_action, +-max_action), demo action)
    on the policy's deterministic mean, emb-dropout off;
  * optax's `clip_by_global_norm(grad_clip)` (`clip_by_global_norm_`),
    then Adam(lr, eps 1e-8);
  * keep the parameters of the epoch with the lowest validation loss.

`il_policy` is the Imitation_learning.py actor: a channels-mode patch
embedding for (B, C, 128, 160) frame stacks, a final LayerNorm, no
emb-dropout. The JAX module takes its patch embedding's width from the
input at init; here a policy's `channels` is fixed when it is built, so
`BCTrainer` takes the policy's constructor (what `il_policy` returns, or
`functools.partial(GoTPolicy, ...)`) and builds it in `init_state` from
the corpus's frame shape.

The corpus goes to the device once. Each epoch uploads only its (N,)
permutation, gathers its batches there, and takes one gradient step a
batch: the loss's policy forward is the gradient-bearing trunk route
(K2f x3 and K3f at the flagship depth, then K3b and K2b x3 backward on
the card), a validation batch the same forward under no_grad. The
epoch's train and validation losses come back to the host as one read;
the best parameters stay on the device as clones until `fit` returns.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch
from torch import nn

from dgvit_tpu_torch.core.device import resolve_device
from dgvit_tpu_torch.models.jax_io import params_from_jax, params_to_jax
from dgvit_tpu_torch.models.policies import GoTPolicy


def il_policy(block: int = 4, head: int = 4, l_f_size: int = 32,
              mlp_dim: int = 2048,
              dtype: Optional[torch.dtype] = None) -> Callable[..., GoTPolicy]:
    """The Imitation_learning.py actor's constructor (the reference's IL
    __main__ does not pass l_f_size, so it is SAC's default 32). Every
    option but `channels` (and `pstate_dim`, `generator`) is bound:
    `BCTrainer.init_state` takes those from the corpus."""
    return functools.partial(GoTPolicy, block=block, head=head,
                             l_f_size=l_f_size, mlp_dim=mlp_dim,
                             patch_mode="channels", final_norm="layer",
                             emb_dropout=0.0, dtype=dtype)


def split_80_20(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """torch.random_split-style random index split (4:1)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    k = int(0.8 * n)
    return perm[:k], perm[k:]


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: where the global L2 norm g of
    all gradients is at least `max_norm`, each becomes (t / g) * max_norm;
    below it they stay as they are. The choice is made on the device."""
    grads = list(grads)
    g_norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / g_norm * max_norm))


@dataclass
class BCState:
    model: GoTPolicy
    opt: torch.optim.Adam
    epoch: int


class BCTrainer:
    """model: the policy's constructor (default `il_policy()`), called as
    model(pstate_dim=..., channels=..., generator=...). device: CUDA
    unless 'cpu'."""

    def __init__(self, model: Optional[Callable[..., GoTPolicy]] = None,
                 lr: float = 1e-3, grad_clip: float = 10.0,
                 max_action: float = 1.0, batch_size: int = 32,
                 seed: int = 1,
                 device: Optional[Union[str, torch.device]] = None):
        if isinstance(model, nn.Module):
            raise TypeError(
                "BCTrainer takes the policy's constructor (il_policy(), "
                "functools.partial(GoTPolicy, ...)), not a built policy: "
                "init_state builds it from the corpus's frame shape")
        self.model = model or il_policy()
        self.lr = float(lr)
        self.grad_clip = float(grad_clip)
        self.max_action = float(max_action)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.device = resolve_device(device)

    def init_state(self, obs_shape=(4, 128, 160), pstate_dim: int = 2,
                   init_params: Optional[Mapping[str, Any]] = None
                   ) -> BCState:
        """The policy for frames of `obs_shape` ((H, W) for a 2d policy,
        (C, H, W) for a channels one), drawn from a generator seeded
        `seed`, or holding `init_params` (a JAX parameter tree, nested or
        flat), and its Adam."""
        obs_shape = tuple(obs_shape)
        channels = obs_shape[0] if len(obs_shape) == 3 else 1
        model = self.model(pstate_dim=pstate_dim, channels=channels,
                           generator=torch.Generator().manual_seed(self.seed))
        want = 3 if model.trans.patch_mode == "channels" else 2
        if len(obs_shape) != want:
            raise ValueError(
                f"a {model.trans.patch_mode!r} policy takes frames of "
                f"{want} dims per sample, the corpus has {obs_shape}")
        if init_params is not None:
            model.load_state_dict(params_from_jax(init_params))
        model = model.to(self.device)
        opt = torch.optim.Adam(model.parameters(), lr=self.lr, eps=1e-8)
        return BCState(model=model, opt=opt, epoch=0)

    # -- loss ----------------------------------------------------------------
    def _rmse(self, model: GoTPolicy, obs, goal, act) -> torch.Tensor:
        mean, _ = model(obs, goal, deterministic=True, inference=False)
        pred = torch.clamp(torch.tanh(mean) * self.max_action,
                           -self.max_action, self.max_action)
        return torch.sqrt(torch.mean(torch.square(pred - act)))

    # -- one epoch -----------------------------------------------------------
    def _epoch(self, state: BCState, corpus: Sequence[torch.Tensor],
               order: np.ndarray, batch: int,
               val: Sequence[torch.Tensor]) -> torch.Tensor:
        """One pass over the batches `order` cuts (len(order) a multiple
        of `batch`), a gradient step each, then the validation batches:
        the (train, val) mean losses as one tensor on the device."""
        idx = torch.from_numpy(order)
        if self.device.type == "cuda":
            idx = idx.pin_memory()
        idx = idx.to(self.device, non_blocking=True)
        nb = len(order) // batch
        bo, bg, ba = (a.index_select(0, idx).view((nb, batch) + a.shape[1:])
                      for a in corpus)
        model, opt = state.model, state.opt
        params = list(model.parameters())
        train = []
        for o, g, a in zip(bo, bg, ba):
            loss = self._rmse(model, o, g, a)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            clip_by_global_norm_([p.grad for p in params
                                  if p.grad is not None], self.grad_clip)
            opt.step()
            train.append(loss.detach())
        with torch.no_grad():
            vals = [self._rmse(model, o, g, a) for o, g, a in zip(*val)]
        state.epoch += 1
        return torch.stack([torch.stack(train).mean(),
                            torch.stack(vals).mean()])

    # -- host-side data plumbing ---------------------------------------------
    @staticmethod
    def _batch_stack(arrs, idx, batch_size):
        """Shuffle + drop remainder + stack into (nb, B, ...)."""
        n = (len(idx) // batch_size) * batch_size
        idx = idx[:n]
        return [a[idx].reshape((-1, batch_size) + a.shape[1:]) for a in arrs]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=self.device)

    def fit(self, obs: np.ndarray, goal: np.ndarray, act: np.ndarray,
            epochs: int = 600, seed: Optional[int] = None,
            verbose: bool = False, to_chw: bool = True,
            init_params: Optional[Mapping[str, Any]] = None
            ) -> Tuple[Dict[str, np.ndarray], Dict[str, List[float]]]:
        """obs (N, 128, 160, 4) NHWC demo recordings (to_chw) or (N, H, W)
        frames; goal (N, >=2); act (N, 2). Returns (best_params, history):
        the lowest-validation-loss parameters as the JAX package's flat
        parameter dict of numpy arrays, and the per-epoch 'train' and
        'val' losses."""
        seed = self.seed if seed is None else int(seed)
        if to_chw and obs.ndim == 4:
            obs = np.transpose(obs, (0, 3, 1, 2))  # torch permute(0,3,1,2)
        goal = goal[:, :2]
        tr, va = split_80_20(len(obs), seed)
        # degenerate tiny datasets: int(0.8*1) == 0 leaves the TRAIN split
        # empty; guard both splits so every epoch has batches
        if len(tr) == 0:
            tr = va
        if len(va) == 0:
            va = tr[: max(1, len(tr) // 5)]
        rng = np.random.default_rng(seed)

        state = self.init_state(obs.shape[1:], goal.shape[1], init_params)
        # the batch clamps: a split smaller than batch_size would stack to
        # zero batches
        vb = max(1, min(self.batch_size, len(va)))
        val = [self._to_device(x) for x in
               self._batch_stack((obs, goal, act), va, vb)]
        corpus = [self._to_device(x) for x in (obs, goal, act)]
        tb = max(1, min(self.batch_size, len(tr)))
        nb = len(tr) // tb

        names = [n for n, _ in state.model.named_parameters()]
        params = [p for _, p in state.model.named_parameters()]
        best_val = np.inf
        best = [p.detach().clone() for p in params]
        hist = {"train": [], "val": []}
        for ep in range(epochs):
            order = rng.permutation(tr)[: nb * tb]
            tr_loss, val_loss = self._epoch(state, corpus, order, tb,
                                            val).tolist()  # the one read
            hist["train"].append(tr_loss)
            hist["val"].append(val_loss)
            if val_loss < best_val:   # keep the lowest-val actor (:830-834)
                best_val = val_loss
                best = [p.detach().clone() for p in params]
            if verbose:
                print(f"Epoch:{ep}, Train and Validation loss are:"
                      f"{tr_loss:.4f}, {val_loss:.4f}")
        return params_to_jax(dict(zip(names, best))), hist
