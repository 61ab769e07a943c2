"""The deterministic deployment map act(obs, goal) -> action, live and as
one deployable file.

Counterpart of `dgvit_tpu/serve/export.py`:

    act(obs[b, ...], goal[b, 2]) -> action[b, 2]

returns tanh(mean) (the evaluate=True branch of the Gaussian actors), or a
deterministic actor's own tanh-squashed output, never squashed twice,
and, with env_units=True, clips it and scales it to robot commands
a_in = [(a0 + 1) * L_SCALE, a1 * A_SCALE] (main.py:320,370).

`make_action_fn` is the live serving form: the GoT actor's trunk runs as
the whole-trunk CUDA kernel (K1), parameters are kept in fp32 and the
compute dtype is bf16 by default.

`export_actor` is the artifact: a `torch.export` program of the same map
in fp32, traced over the composed plain route (`attn_impl="xla"`, as the
JAX export traces its XLA path), so no custom kernel and none of their
shape- or device-based route rules is in the program; the batch dimension
is symbolic (any b >= 1) unless `batch` pins it. `load_actor` gives back
a callable. Where JAX's StableHLO artifact is multi-platform (cpu + tpu),
an exported PyTorch program is bound to the device it was traced on:
`platforms` names exactly one of 'cpu' or 'cuda' ('gpu'), and anything
else raises a ValueError that says why.

    python -m dgvit_tpu_torch.serve.export --actor <name>_actor.npz \
        --out actor.pt2 [--config cfg.yaml] [--env-units] \
        [--platforms cuda|cpu] [--batch 64]
"""

from __future__ import annotations

import argparse
import io
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from dgvit_tpu_torch.core.device import resolve_device
from dgvit_tpu_torch.models.jax_io import params_from_jax
from dgvit_tpu_torch.models.policies import build_actor

MAX_BATCH = 65536       # the symbolic batch's upper bound


def _obs_tail(cfg) -> tuple:
    """The per-frame observation shape after the batch dim."""
    ih, iw = cfg.model.image_size
    if cfg.model.patch_mode == "channels":
        return (cfg.env.frame_stack, ih, iw)
    return (ih, iw)


def _command_units(a: torch.Tensor, e) -> torch.Tensor:
    a = torch.clamp(a, -e.max_action, e.max_action)
    return torch.stack([(a[..., 0] + 1.0) * e.linear_cmd_scale,
                        a[..., 1] * e.angular_cmd_scale], dim=-1)


def make_action_fn(cfg, params: Mapping[str, Any], env_units: bool = False,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[Union[str, torch.device]] = None):
    """Numpy-out act(obs, goal), closed over `params` (the JAX package's
    actor parameter tree, nested or flat as `load_params_npz` returns it).
    obs and goal are numpy arrays, or tensors (states that
    `preprocess_depth_auto` left on the card go in without a round trip
    through the host). Runs on CUDA unless device='cpu'; the returned
    action is fp32. The built actor is `act.policy`."""
    dev = resolve_device(device)
    policy = build_actor(cfg, dtype=dtype)
    policy.load_state_dict(params_from_jax(params))
    policy = policy.to(dev).eval()
    deterministic = cfg.model.actor_type.startswith("Deterministic")
    e = cfg.env

    @torch.no_grad()
    def act(obs, goal) -> np.ndarray:
        o, g = (x.to(dev, torch.float32) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x, np.float32), device=dev)
                for x in (obs, goal))
        out = policy(o, g, inference=True)
        a = out if deterministic else torch.tanh(out[0])
        if env_units:
            a = _command_units(a, e)
        return a.float().cpu().numpy()

    act.policy = policy
    return act


class ActionMap(nn.Module):
    """The deployment map as a module: the actor's deterministic forward
    (no dropout, the route its `attn_impl` gives), then tanh(mean) or a
    deterministic actor's output, then the command units when asked."""

    def __init__(self, policy: nn.Module, deterministic: bool,
                 env_units: bool, env_cfg):
        super().__init__()
        self.policy = policy
        self.deterministic, self.env_units = deterministic, env_units
        self.env_cfg = env_cfg

    def forward(self, obs: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        out = self.policy(obs, goal)
        a = out if self.deterministic else torch.tanh(out[0])
        return _command_units(a, self.env_cfg) if self.env_units else a


def export_device(platforms: Union[str, Sequence[str]]) -> torch.device:
    """The one device an exported program is traced on and bound to."""
    names = [platforms] if isinstance(platforms, str) else list(platforms)
    if len(names) != 1:
        raise ValueError(
            f"platforms {names}: an exported PyTorch program is bound to "
            "the device it was traced on; export once per platform, each "
            "with one of 'cpu' or 'cuda'")
    name = str(names[0]).lower()
    if name == "cpu":
        return torch.device("cpu")
    if name in ("cuda", "gpu"):
        return resolve_device(None)
    if name == "tpu":
        raise ValueError(
            "platform 'tpu': the port's artifact is a PyTorch program, "
            "which runs on 'cpu' or 'cuda' (the JAX package's StableHLO "
            "export serves a TPU)")
    raise ValueError(f"unknown platform {name!r}: one of 'cpu' or 'cuda'")


def action_map(cfg, params: Mapping[str, Any], env_units: bool = False,
               device: Optional[Union[str, torch.device]] = None
               ) -> ActionMap:
    """The fp32 deployment map over the composed plain route, the actor
    carrying `params` (a JAX tree, nested or flat), on `device`."""
    policy = build_actor(cfg, attn_impl="xla")
    policy.load_state_dict(params_from_jax(params))
    return ActionMap(policy, cfg.model.actor_type.startswith("Deterministic"),
                     env_units, cfg.env).to(resolve_device(device)).eval()


def export_actor(cfg, params: Mapping[str, Any], env_units: bool = False,
                 platforms: Union[str, Sequence[str]] = ("cuda",),
                 batch: Optional[int] = None) -> bytes:
    """The actor's deployment map as `torch.export` bytes, traced on the
    one platform named. batch=None exports a symbolic batch dimension (any
    1 <= b <= MAX_BATCH at run time); an int pins it."""
    dev = export_device(platforms)
    module = action_map(cfg, params, env_units, dev)
    b = 2 if batch is None else int(batch)
    args = (torch.zeros((b, *_obs_tail(cfg)), device=dev),
            torch.zeros((b, cfg.sac.pstate_dim), device=dev))
    dynamic = None
    if batch is None:
        dim = torch.export.Dim("b", min=1, max=MAX_BATCH)
        dynamic = {"obs": {0: dim}, "goal": {0: dim}}
    with torch.no_grad():
        program = torch.export.export(module, args, dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_actor(data: bytes):
    """bytes -> act(obs, goal): tensors (or numpy arrays, moved to the
    program's device) in, the action tensor out; shapes are checked
    against the exported symbolic or pinned batch. The program is
    `act.program`, its device `act.device`."""
    program = torch.export.load(io.BytesIO(data))
    fn = program.module()
    dev = next(iter(program.state_dict.values())).device

    @torch.no_grad()
    def act(obs, goal) -> torch.Tensor:
        o, g = (x if isinstance(x, torch.Tensor) else
                torch.as_tensor(np.asarray(x, np.float32), device=dev)
                for x in (obs, goal))
        return fn(o, g)

    act.program, act.device = program, dev
    return act


def main(argv=None):
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core import checkpoint as ckpt

    p = argparse.ArgumentParser(
        description="export an actor as a torch.export program")
    p.add_argument("--actor", required=True,
                   help="actor params npz (save_params_npz output)")
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--config", default=None)
    p.add_argument("--env-units", action="store_true",
                   help="bake clip + command scaling: the artifact emits "
                        "[linear m/s, angular rad/s] robot commands")
    p.add_argument("--platforms", default="cuda",
                   help="the one device to trace on: cuda or cpu")
    p.add_argument("--batch", type=int, default=None,
                   help="pin the batch dim (default: symbolic, any b)")
    args = p.parse_args(argv)

    cfg = Config.from_yaml(args.config) if args.config else Config()
    data = export_actor(cfg, ckpt.load_params_npz(args.actor),
                        env_units=args.env_units,
                        platforms=args.platforms.split(","),
                        batch=args.batch)
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"exported {args.actor} -> {args.out} "
          f"({len(data)} bytes, platform={args.platforms}, "
          f"batch={'symbolic' if args.batch is None else args.batch})")


if __name__ == "__main__":
    main()
