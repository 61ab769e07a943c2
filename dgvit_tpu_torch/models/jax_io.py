"""Carry the JAX package's parameters into the port's modules.

Input is the actor parameter tree as the JAX package stores it: nested
dicts, or the flat '/'-joined form of its `save_params_npz` files
(`core/checkpoint.load_params_npz`), with numpy (or array-like) leaves.
Output is a `state_dict` for `models.policies.GoTPolicy` (or, for a bare
GoT tree, for `models.got.GoT`).

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
_LINEARS = ("fc_embed", "fc1", "fc2", "mean_linear", "log_std_linear")


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
