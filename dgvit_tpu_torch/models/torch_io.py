"""Reference PyTorch checkpoints into the port's networks.

Counterpart of `dgvit_tpu/models/torch_io.py`: the reference's state-dict
keys (got_sac_network.py / GoalFormer.py module paths) mapped onto the
port's modules, for the GoT actor and critic and the CNN actors and
critic. Each map builds the JAX package's parameter tree from the
reference's keys, as the JAX module does, and hands it to
`jax_io.params_from_jax`, so a reference checkpoint lands in the port
exactly where the same checkpoint lands in the JAX package.

Key map (GoT trunk, GoalFormer.py):
  trans.to_patch_embedding.1.{weight,bias} -> trans/patch_embed
  trans.pos_embedding                      -> trans/pos_embedding
  trans.transformer.layers.{i}.0.norm.*    -> .../block_i/attn_norm
  trans.transformer.layers.{i}.0.fn.to_qkv.weight -> .../attn/to_qkv
  trans.transformer.layers.{i}.0.fn.to_out.0.*    -> .../attn/to_out
  trans.transformer.layers.{i}.1.norm.*    -> .../block_i/ff_norm
  trans.transformer.layers.{i}.1.fn.net.0.* -> .../ff/fc1
  trans.transformer.layers.{i}.1.fn.net.3.* -> .../ff/fc2
  trans.layer_norm.g                        -> trans/norm_out/g (RMSNorm)
  trans.cls_token / trans.mlp_head.*        -> unused by the reference's
                                               forward, dropped
CNN (got_sac_network.py): conv{1,2,3}.{weight,bias} -> trunk/conv{1,2,3},
and the Linears by name (`mean` for DeterministicPolicy's output).

Torch Linear weights are (out, in) and flax kernels (in, out); torch
Conv2d weights are (out, in, kh, kw) and flax (kh, kw, in, out): each
goes to the JAX layout here and back to the port's in `params_from_jax`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from dgvit_tpu_torch.models.jax_io import params_from_jax


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _linear(sd: Mapping[str, Any], prefix: str,
            bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[prefix + ".weight"]).T}
    if bias and prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def _layernorm(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[prefix + ".weight"]),
            "bias": _np(sd[prefix + ".bias"])}


def _conv(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    w = _np(sd[prefix + ".weight"])  # (out, in, kh, kw)
    return {"kernel": w.transpose(2, 3, 1, 0),
            "bias": _np(sd[prefix + ".bias"])}


def got_tree_from_torch(sd: Mapping[str, Any], prefix: str = "trans.",
                        depth: int = 4, final_norm: str = "rms"
                        ) -> Dict[str, Any]:
    """The GoT trunk's JAX parameter tree from a reference state dict."""
    p: Dict[str, Any] = {
        "patch_embed": _linear(sd, prefix + "to_patch_embedding.1"),
        "pos_embedding": _np(sd[prefix + "pos_embedding"]),
    }
    blocks = {}
    for i in range(depth):
        lp = f"{prefix}transformer.layers.{i}."
        blocks[f"block_{i}"] = {
            "attn_norm": _layernorm(sd, lp + "0.norm"),
            "attn": {"to_qkv": _linear(sd, lp + "0.fn.to_qkv", bias=False),
                     "to_out": _linear(sd, lp + "0.fn.to_out.0")},
            "ff_norm": _layernorm(sd, lp + "1.norm"),
            "ff": {"fc1": _linear(sd, lp + "1.fn.net.0"),
                   "fc2": _linear(sd, lp + "1.fn.net.3")},
        }
    p["transformer"] = blocks
    if final_norm == "rms":
        p["norm_out"] = {"g": _np(sd[prefix + "layer_norm.g"])}
    else:
        p["norm_out"] = _layernorm(sd, prefix + "layer_norm")
    return p


def got_policy_state_from_torch(sd: Mapping[str, Any], depth: int = 4,
                                final_norm: str = "rms"
                                ) -> Dict[str, torch.Tensor]:
    """A reference GoTPolicy state dict (got_sac_network.py:172-256) ->
    the state_dict of `policies.GoTPolicy`."""
    return params_from_jax({
        "fc_embed": _linear(sd, "fc_embed"),
        "trans": got_tree_from_torch(sd, "trans.", depth, final_norm),
        "fc1": _linear(sd, "fc1"),
        "fc2": _linear(sd, "fc2"),
        "mean_linear": _linear(sd, "mean_linear"),
        "log_std_linear": _linear(sd, "log_std_linear"),
    })


def got_q_state_from_torch(sd: Mapping[str, Any], depth: int = 4
                           ) -> Dict[str, torch.Tensor]:
    """A reference GoT QNetwork state dict (got_sac_network.py:75-123) ->
    the state_dict of `policies.GoTQNetwork`."""
    return params_from_jax({
        "fc_embed": _linear(sd, "fc_embed"),
        "trans": got_tree_from_torch(sd, "trans.", depth),
        **{k: _linear(sd, k) for k in ("fc1", "fc2", "fc3", "fc11", "fc21",
                                       "fc31")},
    })


def cnn_policy_state_from_torch(sd: Mapping[str, Any],
                                mean_key: str = "mean_linear"
                                ) -> Dict[str, torch.Tensor]:
    """A reference GaussianPolicy or DeterministicPolicy state dict
    (got_sac_network.py:258-387) -> the state_dict of
    `policies.GaussianPolicy` (`mean_key` 'mean_linear') or
    `policies.DeterministicPolicy` ('mean'); the output layer is read
    from either name."""
    p = {
        "trunk": {f"conv{i}": _conv(sd, f"conv{i}") for i in (1, 2, 3)},
        "fc_embed": _linear(sd, "fc_embed"),
        "fc1": _linear(sd, "fc1"),
        "fc2": _linear(sd, "fc2"),
    }
    if "log_std_linear.weight" in sd:
        p["log_std_linear"] = _linear(sd, "log_std_linear")
    p[mean_key] = _linear(sd, mean_key if mean_key + ".weight" in sd
                          else "mean")
    return params_from_jax(p)


def cnn_q_state_from_torch(sd: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """A reference CNN QNetwork state dict (got_sac_network.py:125-170) ->
    the state_dict of `policies.QNetwork`."""
    return params_from_jax({
        "trunk": {f"conv{i}": _conv(sd, f"conv{i}") for i in (1, 2, 3)},
        "fc_embed": _linear(sd, "fc_embed"),
        **{k: _linear(sd, k) for k in ("fc1", "fc2", "fc3", "fc11", "fc21",
                                       "fc31")},
    })


def load_actor_pth(path: str, depth: int = 4) -> Dict[str, torch.Tensor]:
    """A reference `*_actor.pth` checkpoint (DRL.py:489-503) -> the
    state_dict of the GoT actor. Loads tensors only (weights_only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return got_policy_state_from_torch(sd, depth=depth)


def load_critic_pth(path: str, depth: int = 4) -> Dict[str, torch.Tensor]:
    """A reference `*_critic.pth` checkpoint -> the GoT critic's
    state_dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return got_q_state_from_torch(sd, depth=depth)
