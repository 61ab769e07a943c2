"""Carry the JAX package's parameters and train state into the port.

`params_from_jax` takes an actor or critic parameter tree as the JAX
package stores it: nested dicts, or the flat '/'-joined form of its
`save_params_npz` files (`core/checkpoint.load_params_npz`), with numpy
(or array-like) leaves. Output is a `state_dict` for any network of
`models.policies` (the GoT, CNN and SimpleViT families), or, for a bare
trunk tree, for `models.got.GoT` or `models.simple_vit.SimpleViT`.

`params_to_jax` is its inverse, for a port-trained actor or critic.

`sac_state_from_jax` carries a whole JAX `SACTrainState` (its leaves as
numpy arrays): actor, critic and target parameters, the optax Adam
moments `mu`/`nu` (same paths and transposes as the parameters) and
`count`, `log_alpha` and `itera`, into the port's agent state.

Flax Dense kernels are (in, out): they are transposed where the port uses
an nn.Linear weight (out, in) (every Linear of the SimpleViT blocks too),
and kept as they are for the GoT blocks, whose raw parameters are stored
(in, out) as the kernel takes them. Flax conv kernels are HWIO and become
OIHW (`k.transpose(3, 2, 0, 1)`). `pos_embedding` stays (1, n + 1, dim).
With head-only fine-tuning (`train.policy_attention_fix` /
`critic_attention_fix`) the optax state is a multi_transform whose Adam
holds only the heads; the port's Adam holds those parameters alone.
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
# SimpleViT (models/simple_vit.py): its Linears are nn.Linear weights
_VIT_BLOCK = {
    "attn_norm/scale": "attn_norm.weight",
    "attn_norm/bias": "attn_norm.bias",
    "attn/to_qkv/kernel": "to_qkv.weight",
    "attn/to_out/kernel": "to_out.weight",
    "ff/norm/scale": "ff_norm.weight",
    "ff/norm/bias": "ff_norm.bias",
    "ff/fc1/kernel": "fc1.weight",
    "ff/fc1/bias": "fc1.bias",
    "ff/fc2/kernel": "fc2.weight",
    "ff/fc2/bias": "fc2.bias",
}
_VIT_TRUNK = {
    "patch_embed/kernel": "patch_embed.weight",
    "patch_embed/bias": "patch_embed.bias",
    "norm_out/scale": "norm_out.weight",
    "norm_out/bias": "norm_out.bias",
    "head_norm/scale": "head_norm.weight",
    "head_norm/bias": "head_norm.bias",
    "head/kernel": "head.weight",
    "head/bias": "head.bias",
}
_LINEARS = ("fc_embed", "fc1", "fc2", "mean_linear", "log_std_linear",
            "fc3", "fc11", "fc21", "fc31", "mean")
_HEADS = {"trans", "trunk", *_LINEARS}
# how a JAX leaf becomes a port tensor: kept, a Dense kernel transposed,
# or an HWIO conv kernel made OIHW
_KEEP, _DENSE, _CONV = "keep", "dense", "conv"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _is_vit(keys) -> bool:
    """A SimpleViT trunk: its FeedForward holds its own norm."""
    return any(re.search(r"transformer/block_\d+/ff/norm/", k) for k in keys)


def _trunk_key(key: str, vit: bool = False):
    """Trunk-relative JAX path -> (port parameter name, kind)."""
    m = re.fullmatch(r"transformer/block_(\d+)/(.+)", key)
    if vit:
        if m and m.group(2) in _VIT_BLOCK:
            return f"transformer.{m.group(1)}.{_VIT_BLOCK[m.group(2)]}", (
                _DENSE if m.group(2).endswith("kernel") else _KEEP)
        if key in _VIT_TRUNK:
            return _VIT_TRUNK[key], (_DENSE if key.endswith("kernel")
                                     else _KEEP)
    else:
        if m and m.group(2) in _BLOCK:
            return (f"transformer.blocks.{m.group(1)}.{_BLOCK[m.group(2)]}",
                    _KEEP)
        if key == "patch_embed/kernel":
            return "patch_embed.weight", _DENSE
        if key in _TRUNK:
            return _TRUNK[key], _KEEP
    raise KeyError(f"no port parameter for JAX path {key!r}")


def _port_key(key: str, vit: bool):
    """Model-relative JAX path -> (port parameter name, kind)."""
    head, _, rest = key.partition("/")
    if head in _LINEARS and rest in ("kernel", "bias"):
        return (f"{head}.{'weight' if rest == 'kernel' else 'bias'}",
                _DENSE if rest == "kernel" else _KEEP)
    m = re.fullmatch(r"(conv\d+)/(kernel|bias)", rest)
    if head == "trunk" and m:
        return (f"trunk.{m.group(1)}.{'weight' if m.group(2) == 'kernel' else 'bias'}",
                _CONV if m.group(2) == "kernel" else _KEEP)
    if head == "trans":
        name, kind = _trunk_key(rest, vit)
        return "trans." + name, kind
    raise KeyError(f"no port parameter for JAX path {key!r}")


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX actor or critic params (or a bare GoT or SimpleViT tree) ->
    port state_dict (fp32 tensors)."""
    flat = _flatten(tree)
    if all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    bare_trunk = not {k.partition("/")[0] for k in flat} & _HEADS
    if bare_trunk:
        flat = {f"trans/{k}": v for k, v in flat.items()}
    vit = _is_vit(flat)
    out = {}
    for key, val in flat.items():
        arr = np.asarray(val, dtype=np.float32)
        name, kind = _port_key(key, vit)
        if kind == _DENSE:
            arr = arr.T
        elif kind == _CONV:
            arr = arr.transpose(3, 2, 0, 1)
        if bare_trunk:
            name = name[len("trans."):]
        out[name] = torch.from_numpy(np.array(arr, order="C"))
    return out


def params_to_jax(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: a port `state_dict` (any actor or
    critic of the zoo, or a bare GoT or SimpleViT) -> the JAX package's
    flat '/'-joined parameter dict of fp32 numpy arrays, as its
    `save_params_npz` files hold it, so a network trained by the port
    loads into the JAX package (and back through `params_from_jax`)
    unchanged."""
    bare_trunk = not any(k.partition(".")[0] in _HEADS for k in state_dict)
    names = [f"trans.{n}" if bare_trunk else n for n in state_dict]
    vit = any(re.match(r"trans\.transformer\.\d+\.", n) for n in names)
    trunk = _VIT_TRUNK if vit else (*_TRUNK, "patch_embed/kernel")
    inverse = {_port_key(f"trans/{k}", vit)[0]: f"trans/{k}" for k in trunk}
    out = {}
    for name, full, val in zip(state_dict, names, state_dict.values()):
        arr = (val.detach().cpu().float().numpy()
               if isinstance(val, torch.Tensor)
               else np.asarray(val, np.float32))
        key = inverse.get(full) or _jax_key(full, vit)
        kind = _port_key(key, vit)[1]
        if kind == _DENSE:
            arr = arr.T
        elif kind == _CONV:
            arr = arr.transpose(2, 3, 1, 0)
        if bare_trunk:
            key = key[len("trans/"):]
        out[key] = np.array(arr, order="C")
    return out


def _jax_key(name: str, vit: bool) -> str:
    """Port parameter name -> its JAX path (a Linear, a conv, a block)."""
    head, _, rest = name.partition(".")
    if head in _LINEARS and rest in ("weight", "bias"):
        return f"{head}/{'kernel' if rest == 'weight' else 'bias'}"
    m = re.fullmatch(r"(conv\d+)\.(weight|bias)", rest)
    if head == "trunk" and m:
        return f"trunk/{m.group(1)}/" + (
            "kernel" if m.group(2) == "weight" else "bias")
    blocks = ({v: k for k, v in _VIT_BLOCK.items()} if vit
              else {v: k for k, v in _BLOCK.items()})
    m = re.fullmatch(r"transformer\.(?:blocks\.)?(\d+)\.(.+)", rest)
    if head == "trans" and m and m.group(2) in blocks:
        return f"trans/transformer/block_{m.group(1)}/{blocks[m.group(2)]}"
    raise KeyError(f"no JAX path for port parameter {name!r}")


def _field(obj, name: str):
    """A field of a JAX struct (attribute) or of a plain dict."""
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _adam(opt_state):
    """The optax scale_by_adam state (count, mu, nu) inside an optimizer
    state (optax.adam's is a tuple around it; a multi_transform's holds
    it among its inner states)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for attr in ("inner_states", "inner_state"):
        if hasattr(opt_state, attr):
            return _adam(getattr(opt_state, attr))
    parts = (opt_state.values() if isinstance(opt_state, Mapping)
             else opt_state if isinstance(opt_state, (tuple, list)) else ())
    for part in parts:
        found = _adam(part)
        if found is not None:
            return found
    return None


def _leaves(tree) -> Dict[str, Any]:
    """A moment tree's array leaves (the masked-out leaves of a
    multi_transform, empty tuples, dropped)."""
    return {k: v for k, v in _flatten(tree).items()
            if not isinstance(v, tuple)}


def _load_adam(opt: torch.optim.Optimizer, named, opt_state) -> None:
    """Set a torch Adam's per-parameter state from an optax Adam state,
    for the parameters the Adam holds."""
    adam = _adam(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (count, mu, nu) found")
    step = torch.tensor(float(np.asarray(adam.count)))
    if isinstance(named, torch.Tensor):       # a bare scalar parameter
        mus = {"": torch.tensor(np.asarray(adam.mu, np.float32))}
        nus = {"": torch.tensor(np.asarray(adam.nu, np.float32))}
        named = [("", named)]
    else:
        mus = params_from_jax(_leaves(adam.mu))
        nus = params_from_jax(_leaves(adam.nu))
    held = {id(p) for group in opt.param_groups for p in group["params"]}
    for name, p in named:
        if id(p) not in held:
            continue
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
