"""Checkpoints: flat parameter files and the full train state.

Counterpart of `dgvit_tpu/core/checkpoint.py`. Parameter files keep the
JAX package's `save_params_npz` layout: one npz entry per leaf, keyed by
the '/'-joined tree path (e.g.
'trans/transformer/block_0/attn/to_qkv/kernel'), so an actor saved by
either package loads into the other. The whole SAC train state (which the
JAX package writes with orbax) is one `torch.save` file per step.
"""

from __future__ import annotations

import copy
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """Read every entry of a flat params npz into a {path: array} dict."""
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


# -- full train state ---------------------------------------------------------

_MODULES = ("actor", "critic", "critic_target")
_OPTS = ("actor_opt", "critic_opt", "alpha_opt")


def state_payload(state) -> Dict[str, Any]:
    """Everything of a `agents.sac.SACState` that `save_train_state`
    writes, as one dict: the parameters of actor, critic and target, the
    three Adam states, `log_alpha`, `itera` and the state of the generator
    that draws dropout masks and action noise, and of the DrQ shifts'
    generator where the state has one (with them a resumed run reproduces
    the next update)."""
    payload = {
        **{k: getattr(state, k).state_dict() for k in _MODULES + _OPTS},
        "log_alpha": state.log_alpha.detach().cpu(),
        "itera": int(state.itera),
        "generator": state.generator.get_state(),
        "generator_device": str(state.generator.device),
    }
    if getattr(state, "aug_generator", None) is not None:
        payload["aug_generator"] = state.aug_generator.get_state()
    return payload


def save_train_state(directory: str, step: int, state) -> str:
    """Write a whole `agents.sac.SACState` (`state_payload`) to
    directory/step_<N>/. The file appears under its name only when
    complete."""
    path = Path(directory).absolute() / f"step_{step}"
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"train_state.{os.getpid()}.tmp"
    torch.save(state_payload(state), tmp)
    os.replace(tmp, path / "train_state.pt")
    return str(path)


def restore_train_state(path: str, template):
    """Load a `save_train_state` checkpoint into `template` (a state built
    by `SACAgent.init_state` for the same config), in place; returns it."""
    return load_payload(template, torch.load(
        Path(path) / "train_state.pt", map_location="cpu",
        weights_only=True))


def load_payload(template, payload: Mapping[str, Any]):
    """`state_payload`'s dict into `template`, in place; returns it. A
    generator saved on another kind of device keeps the template's
    stream: its state would mean nothing there."""
    for k in _MODULES:
        getattr(template, k).load_state_dict(payload[k])
    for k in _OPTS:
        # Optimizer.load_state_dict casts the moments to each parameter's
        # device and dtype, and keeps a tensor already there as it is: the
        # copy keeps the template's steps out of `payload`
        getattr(template, k).load_state_dict(copy.deepcopy(payload[k]))
    with torch.no_grad():
        template.log_alpha.copy_(payload["log_alpha"])
    template.itera = int(payload["itera"])
    saved_on = torch.device(payload["generator_device"]).type
    if saved_on == template.generator.device.type:
        template.generator.set_state(payload["generator"])
        aug = getattr(template, "aug_generator", None)
        if aug is not None and "aug_generator" in payload:
            aug.set_state(payload["aug_generator"])
    return template


def _numbered(directory: str, pattern: str):
    """(N, path) of every entry of `directory` whose name matches."""
    d = Path(directory)
    if not d.exists():
        return []
    found = []
    for p in d.iterdir():
        m = re.fullmatch(pattern, p.name)
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found)


def latest_checkpoint(directory: str) -> Optional[str]:
    steps = _numbered(directory, r"step_(\d+)")
    return str(steps[-1][1]) if steps else None


def prune_checkpoints(directory: str, keep: int = 3) -> int:
    """Delete all but the newest `keep` step_<N> checkpoints (highest step
    wins). Returns the number pruned."""
    steps = _numbered(directory, r"step_(\d+)")
    gone = steps[:-keep] if keep > 0 else steps
    for _, p in gone:
        shutil.rmtree(p, ignore_errors=True)
    return len(gone)


def prune_step_files(directory: str, prefix: str, keep: int = 3) -> int:
    """Delete all but the newest `keep` `{prefix}_<N>.npz` sidecar files
    (replay snapshots beside the step_<N> checkpoints)."""
    found = _numbered(directory, rf"{re.escape(prefix)}_(\d+)\.npz")
    gone = found[:-keep] if keep > 0 else found
    for _, p in gone:
        p.unlink(missing_ok=True)
    return len(gone)


# -- reference-style named exports (DRL.py:489-497 filename contract) ---------

def reference_name(filename: str, reward: float, seed: int,
                   nb_col: int = 100) -> str:
    """'%s_reward_%s_nbCol_%s_seed_%s' (DRL.py:490)."""
    return f"{filename}_reward_{reward}_nbCol_{nb_col}_seed_{seed}"


def save_params_npz(directory: str, name: str, params: Mapping[str, Any],
                    kind: str = "actor") -> str:
    """Save a parameter tree in the JAX package's layout as a flat npz
    ('<name>_<kind>.npz', one entry per leaf keyed by its '/'-joined
    path): nested dicts or already-flat, as `models.jax_io.params_to_jax`
    returns it."""
    flat = {}

    def visit(prefix, node):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                visit(key, v)
            else:
                flat[key] = np.asarray(v)

    visit("", params)
    os.makedirs(directory, exist_ok=True)
    out = Path(directory) / f"{name}_{kind}.npz"
    np.savez_compressed(out, **flat)
    return str(out)
