"""The sensor-fault transforms shared by the robustness sweep and the
fused loop's training-time augmentation.

Counterpart of `dgvit_tpu/envs/fault_aug.py`: the reference's five-fault
family (env_lab.py:33-90: Gaussian noise, Gaussian blur, pixel occlusion,
superpixel occlusion, greying) on tensors, each knob a host float. A knob
at 0.0 is skipped by a host `if`, so the frame comes back bit-identical
and nothing is read from the card. `blur` blends toward the 5x5-Gaussian
frame; `patch_occlusion` zeroes one random rectangle of that area
fraction per lane (the contiguous-region dropout of superpixel occlusion,
env_lab.py:49-59), the same rectangle over a lane's frame stack.

Two callers: `train.evaluate.run_eval_vec(sweep=...)`, the robustness
grid, and `train.vec_rollout.make_collect_fn(fault_knobs=...)`, where the
actor acts on, and the ring stores, perturbed frames.

Draws. Whenever any knob is on, every call draws all four of JAX's
arrays from one generator, in JAX's order: the noise's standard normals
(the frames' shape), the occlusion's uniforms (the frames' shape), then
the patch's y0 and x0 uniforms (one a lane each). The count and order of
draws thus do not depend on the knobs' values, so two knob settings that
start from the same generator see the same realization at every step:
the sweep's points are paired. `draws=` hands the four arrays in (tests
feed JAX's own).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dgvit_tpu_torch.ops.preprocess import gaussian_blur

# the canonical knob order: sweeps and augmentation both pack a knob dict
# into five values in this order
KNOB_KEYS = ("obs_noise", "blur", "occlusion", "patch_occlusion", "greying")

Knobs = Tuple[float, float, float, float, float]
Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def knobs_array(pt: Optional[Dict[str, float]]) -> Knobs:
    """{knob: value} (a missing key is 0.0) -> five host floats in
    KNOB_KEYS order, each rounded to fp32 as JAX's f32 array holds it."""
    pt = pt or {}
    unknown = set(pt) - set(KNOB_KEYS)
    assert not unknown, f"unknown fault knobs: {sorted(unknown)}"
    return tuple(float(np.float32(pt.get(k, 0.0))) for k in KNOB_KEYS)


def any_on(knobs: Sequence[float]) -> bool:
    """Whether any knob perturbs (a host test: no read of the card)."""
    return any(k > 0.0 for k in knobs)


def draw_faults(shape: Sequence[int],
                generator: Optional[torch.Generator] = None,
                device=None) -> Draws:
    """The four draws of one `perturb_obs` call on frames of `shape`, in
    JAX's order: normals (shape), uniforms (shape), y0 and x0 uniforms
    (shape[0],)."""
    b = shape[0]
    kw = dict(generator=generator, device=device)
    return (torch.randn(tuple(shape), **kw), torch.rand(tuple(shape), **kw),
            torch.rand((b,), **kw), torch.rand((b,), **kw))


def patch_keep(shape: Sequence[int], patch: float, y0u: torch.Tensor,
               x0u: torch.Tensor) -> torch.Tensor:
    """The pixels a lane keeps under a patch of area fraction `patch`:
    bool, broadcastable to `shape` (one rectangle a lane over its stack).
    fp32 throughout, as JAX computes it (`fault_aug.py:74-87`): the side,
    the rectangle's size and corner, and the iota comparisons."""
    ih, iw = shape[-2], shape[-1]
    f32 = np.float32
    side = np.sqrt(np.maximum(f32(patch), f32(0.0)))
    ph, pw = side * f32(ih), side * f32(iw)
    y0 = y0u.float() * float(f32(ih) - ph)
    x0 = x0u.float() * float(f32(iw) - pw)
    ex = (1,) * (len(shape) - 3)     # broadcast over the frame-stack axis
    y0 = y0.reshape((-1,) + ex + (1, 1))
    x0 = x0.reshape((-1,) + ex + (1, 1))
    dev = y0u.device
    yy = torch.arange(ih, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(iw, dtype=torch.float32, device=dev)[None, :]
    return ~((yy >= y0) & (yy < y0 + float(ph))
             & (xx >= x0) & (xx < x0 + float(pw)))


def perturb_obs(obs: torch.Tensor, knobs: Sequence[float],
                generator: Optional[torch.Generator] = None,
                draws: Optional[Draws] = None) -> torch.Tensor:
    """The five-fault family on a batch of depth frames on the [0, 1]
    scale: `obs` (B, H, W) or (B, C, H, W); `knobs` five host floats in
    KNOB_KEYS order (`knobs_array`). With every knob at 0.0 `obs` itself
    comes back and nothing is drawn; else the four draws come from
    `draws`, or from `generator` (`draw_faults`), and the knobs that are
    on apply in JAX's order: noise (clipped to [0, 1]), blur, occlusion,
    patch, greying."""
    noise, blur, occ, patch, grey = (float(k) for k in knobs)
    if not any_on(knobs):
        return obs
    if draws is None:
        draws = draw_faults(obs.shape, generator, obs.device)
    n, u, y0u, x0u = draws
    f32 = np.float32
    if noise > 0.0:
        obs = torch.clamp(obs + noise * n, 0.0, 1.0)
    if blur > 0.0:
        obs = (float(f32(1.0) - f32(blur)) * obs
               + blur * gaussian_blur(obs, 5))
    if occ > 0.0:
        obs = obs * (u >= occ)
    if patch > 0.0:
        obs = obs * patch_keep(obs.shape, patch, y0u, x0u)
    if grey > 0.0:
        obs = obs * float(f32(1.0) - f32(grey)) + float(f32(0.5) * f32(grey))
    return obs
