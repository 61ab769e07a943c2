"""Carry the JAX package's parameters and train state into the port.

`params_from_jax` takes an actor or critic parameter tree as the JAX
package stores it: nested dicts, or the flat '/'-joined form of its
`save_params_npz` files (`core/checkpoint.load_params_npz`), with numpy
(or array-like) leaves. Output is a `state_dict` for
`models.policies.GoTPolicy` or `GoTQNetwork` (or, for a bare GoT tree, for
`models.got.GoT`).

`params_to_jax` is its inverse, for a port-trained actor or critic.

`sac_state_from_jax` carries a whole JAX `SACTrainState` (its leaves as
numpy arrays): actor, critic and target parameters, the optax Adam
moments `mu`/`nu` (same paths and transposes as the parameters) and
`count`, `log_alpha` and `itera`, into the port's agent state.

Flax Dense kernels are (in, out): they are transposed where the port uses
an nn.Linear weight (out, in), and kept as they are for the transformer
blocks, whose raw parameters are stored (in, out) as the kernel takes
them. `pos_embedding` stays (1, n + 1, dim).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_BLOCK = {
    "attn_norm/scale": "attn_norm_scale",
    "attn_norm/bias": "attn_norm_bias",
    "attn/to_qkv/kernel": "wqkv",
    "attn/to_out/kernel": "wout",
    "attn/to_out/bias": "bout",
    "ff_norm/scale": "ff_norm_scale",
    "ff_norm/bias": "ff_norm_bias",
    "ff/fc1/kernel": "w1",
    "ff/fc1/bias": "b1",
    "ff/fc2/kernel": "w2",
    "ff/fc2/bias": "b2",
}
_TRUNK = {
    "pos_embedding": "pos_embedding",
    "norm_out/g": "norm_out.g",
    "norm_out/scale": "norm_out.weight",
    "norm_out/bias": "norm_out.bias",
    "patch_embed/bias": "patch_embed.bias",
}
_LINEARS = ("fc_embed", "fc1", "fc2", "mean_linear", "log_std_linear",
            "fc3", "fc11", "fc21", "fc31")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _trunk_key(key: str) -> str:
    """GoT-relative JAX path -> port parameter name."""
    m = re.fullmatch(r"transformer/block_(\d+)/(.+)", key)
    if m and m.group(2) in _BLOCK:
        return f"transformer.blocks.{m.group(1)}.{_BLOCK[m.group(2)]}"
    if key in _TRUNK:
        return _TRUNK[key]
    raise KeyError(f"no port parameter for JAX path {key!r}")


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX actor (or bare GoT) params -> port state_dict (fp32 tensors)."""
    flat = _flatten(tree)
    if all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    heads = {k.partition("/")[0] for k in flat}
    bare_trunk = not heads & {"trans", *_LINEARS}
    out = {}
    for key, val in flat.items():
        arr = np.asarray(val, dtype=np.float32)
        head, _, rest = (f"trans/{key}" if bare_trunk else key).partition("/")
        if head in _LINEARS and rest in ("kernel", "bias"):
            name = f"{head}.{'weight' if rest == 'kernel' else 'bias'}"
            transpose = rest == "kernel"
        elif head == "trans" and rest == "patch_embed/kernel":
            name, transpose = "trans.patch_embed.weight", True
        elif head == "trans":
            name, transpose = "trans." + _trunk_key(rest), False
        else:
            raise KeyError(f"no port parameter for JAX path {key!r}")
        if transpose:
            arr = arr.T
        if bare_trunk:
            name = name[len("trans."):]
        out[name] = torch.from_numpy(np.array(arr, order="C"))
    return out


def params_to_jax(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: a port `state_dict` (GoTPolicy,
    GoTQNetwork or a bare GoT) -> the JAX package's flat '/'-joined
    parameter dict of fp32 numpy arrays, as its `save_params_npz` files
    hold it, so an actor trained by the port loads into the JAX package
    (and back through `params_from_jax`) unchanged."""
    inv_block = {v: k for k, v in _BLOCK.items()}
    inv_trunk = {v: k for k, v in _TRUNK.items()}
    bare_trunk = not any(k.partition(".")[0] in ("trans", *_LINEARS)
                         for k in state_dict)
    out = {}
    for name, val in state_dict.items():
        arr = (val.detach().cpu().float().numpy()
               if isinstance(val, torch.Tensor)
               else np.asarray(val, np.float32))
        head, _, rest = (f"trans.{name}" if bare_trunk else name
                         ).partition(".")
        transpose = False
        if head in _LINEARS and rest in ("weight", "bias"):
            key = f"{head}/{'kernel' if rest == 'weight' else 'bias'}"
            transpose = rest == "weight"
        elif head == "trans" and rest == "patch_embed.weight":
            key, transpose = "trans/patch_embed/kernel", True
        elif head == "trans" and rest in inv_trunk:
            key = "trans/" + inv_trunk[rest]
        else:
            m = re.fullmatch(r"transformer\.blocks\.(\d+)\.(\w+)", rest)
            if head != "trans" or not m or m.group(2) not in inv_block:
                raise KeyError(f"no JAX path for port parameter {name!r}")
            key = (f"trans/transformer/block_{m.group(1)}/"
                   f"{inv_block[m.group(2)]}")
        if bare_trunk:
            key = key[len("trans/"):]
        out[key] = np.array(arr.T if transpose else arr, order="C")
    return out


def _field(obj, name: str):
    """A field of a JAX struct (attribute) or of a plain dict."""
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _adam(opt_state):
    """The optax scale_by_adam state (count, mu, nu) inside an optimizer
    state (optax.adam's is a tuple around it)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam(part)
            if found is not None:
                return found
    return None


def _load_adam(opt: torch.optim.Optimizer, named, opt_state) -> None:
    """Set a torch Adam's per-parameter state from an optax Adam state."""
    adam = _adam(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (count, mu, nu) found")
    step = torch.tensor(float(np.asarray(adam.count)))
    if isinstance(named, torch.Tensor):       # a bare scalar parameter
        mus = {"": torch.tensor(np.asarray(adam.mu, np.float32))}
        nus = {"": torch.tensor(np.asarray(adam.nu, np.float32))}
        named = [("", named)]
    else:
        mus, nus = params_from_jax(adam.mu), params_from_jax(adam.nu)
    for name, p in named:
        opt.state[p] = {
            "step": step.clone(),
            "exp_avg": mus[name].reshape(p.shape).to(p.device).clone(),
            "exp_avg_sq": nus[name].reshape(p.shape).to(p.device).clone()}


def sac_state_from_jax(agent, tree):
    """The port's agent state (`agents.sac.SACState`) holding a JAX
    `SACTrainState`: `agent.init_state()` with every parameter, Adam
    moment, `log_alpha` and `itera` replaced by the JAX state's."""
    state = agent.init_state()
    for module, key in ((state.actor, "actor_params"),
                        (state.critic, "critic_params"),
                        (state.critic_target, "critic_target_params")):
        module.load_state_dict(params_from_jax(_field(tree, key)))
    _load_adam(state.actor_opt, state.actor.named_parameters(),
               _field(tree, "actor_opt"))
    _load_adam(state.critic_opt, state.critic.named_parameters(),
               _field(tree, "critic_opt"))
    with torch.no_grad():
        state.log_alpha.fill_(float(np.asarray(_field(tree, "log_alpha"))))
    _load_adam(state.alpha_opt, state.log_alpha, _field(tree, "alpha_opt"))
    state.itera = int(np.asarray(_field(tree, "itera")))
    return state
