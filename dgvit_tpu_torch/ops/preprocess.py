"""Depth/fisheye preprocessing chain with cv2-exact numerics, on tensors.

Counterpart of `dgvit_tpu/ops/preprocess.py`: the reference's per-frame
OpenCV pipeline (env_lab.py:420-434 + :295-299) as plain PyTorch functions
over (..., H, W) stacks, on any device:

    float depth -> minmax normalize 0..255 -> u8 truncation (kept in fp32)
    + N(0, sigma), clip [0, 255], GaussianBlur 5x5
    center h/5 band GaussianBlur 11x11 (band extracted first)
    bilinear resize to (128, 160) -> /255

cv2 semantics kept exactly as the JAX functions keep them:
  * GaussianBlur(k, sigma=0): k <= 7 uses cv2's fixed binomial tables,
    k > 7 uses sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8;
  * borders are BORDER_REFLECT_101;
  * the band blur reflects at the band's own edges;
  * resize samples src = (dst + 0.5) * scale - 0.5, clamped to the edge.

The blur is written as shifted adds in the JAX function's order (rows,
then columns, taps first to last), so fp32 results agree to rounding.
This chain is also the oracle of the fused CUDA kernel
(`ops/fused_preprocess.py`). Noise comes from a `torch.Generator`, or is
handed in (`noise=`) where two versions must see the same draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_SMALL_GAUSSIAN_TAB = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel: fixed binomial tables for ksize <= 7 with
    sigma <= 0, else exp(-x^2 / (2 sigma^2)) normalized, with the default
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8. float64."""
    if sigma <= 0 and ksize <= 7 and ksize % 2 == 1:
        return np.asarray(_SMALL_GAUSSIAN_TAB[ksize], np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    center = (ksize - 1) * 0.5
    x = np.arange(ksize, dtype=np.float64) - center
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Indices -r .. n-1+r reflected into 0 .. n-1 (REFLECT_101)."""
    i = torch.arange(-r, n + r, device=device)
    i = i.abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _sep_blur(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable blur with BORDER_REFLECT_101 on the last two dims."""
    r = len(k) // 2
    kf = torch.as_tensor(np.asarray(k), dtype=img.dtype, device=img.device)
    h, w = img.shape[-2], img.shape[-1]
    x = img.index_select(-2, _reflect_index(h, r, img.device))
    acc = torch.zeros_like(img)
    for i in range(len(k)):
        acc = acc + kf[i] * x[..., i:i + h, :]
    x2 = acc.index_select(-1, _reflect_index(w, r, img.device))
    out = torch.zeros_like(img)
    for i in range(len(k)):
        out = out + kf[i] * x2[..., i:i + w]
    return out


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float = 0.0
                  ) -> torch.Tensor:
    """cv2.GaussianBlur(img, (k, k), sigma) on (..., H, W)."""
    return _sep_blur(img, gaussian_kernel_1d(ksize, sigma))


def center_band(h: int) -> Tuple[int, int]:
    """Horizontal center band of height h // 5 (env_lab.py:33-39)."""
    band = h // 5
    y1 = h // 2 - band // 2
    return y1, y1 + band


def _with_band(img: torch.Tensor, band: torch.Tensor, y1: int, y2: int
               ) -> torch.Tensor:
    return torch.cat([img[..., :y1, :], band, img[..., y2:, :]], dim=-2)


def band_blur(img: torch.Tensor, ksize: int = 11) -> torch.Tensor:
    """blurring() (env_lab.py:69-76): the band is extracted, blurred with
    REFLECT_101 at its own edges, and pasted back."""
    y1, y2 = center_band(img.shape[-2])
    return _with_band(img, gaussian_blur(img[..., y1:y2, :], ksize), y1, y2)


def pixel_occlusion(img: torch.Tensor) -> torch.Tensor:
    """env_lab.py:41-47: zero out the center band (fp32 like the
    reference)."""
    img = img.to(torch.float32)
    y1, y2 = center_band(img.shape[-2])
    return _with_band(img, torch.zeros_like(img[..., y1:y2, :]), y1, y2)


def greying_out(img: torch.Tensor) -> torch.Tensor:
    """env_lab.py:61-67: paint the center band grey (128)."""
    y1, y2 = center_band(img.shape[-2])
    return _with_band(img, torch.full_like(img[..., y1:y2, :], 128), y1, y2)


def add_noise(img: torch.Tensor, generator: Optional[torch.Generator] = None,
              noise_level: float = 50.0,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """add_nose() (env_lab.py:78-90): fp32 + sigma * N(0, 1), clip
    [0, 255], GaussianBlur 5x5. The standard normal draws come from
    `generator` (on the image's device), or are `noise` when given."""
    img = img.to(torch.float32)
    if noise is None:
        noise = torch.randn(img.shape, dtype=torch.float32,
                            device=img.device, generator=generator)
    noisy = torch.clamp(img + noise_level * noise.to(torch.float32),
                        0.0, 255.0)
    return gaussian_blur(noisy, 5)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` as a 0-dim tensor beside `like`. A division by it is a true
    IEEE division on every device (PyTorch's CUDA division by a Python
    number multiplies by the reciprocal instead, which rounds otherwise
    than the CPU's)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def normalize_depth_f32(img: torch.Tensor) -> torch.Tensor:
    """cv2.normalize(img, None, 0, 255, NORM_MINMAX) per image, then the
    reference's .astype(np.uint8), a truncation, kept in fp32 as floor().
    A constant frame gives zeros."""
    lo = img.amin(dim=(-2, -1), keepdim=True)
    hi = img.amax(dim=(-2, -1), keepdim=True)
    scaled = (img - lo) * (_scalar(255.0, img) / torch.clamp(hi - lo,
                                                             min=1e-20))
    return torch.clamp(torch.floor(scaled), 0.0, 255.0)


def normalize_depth_u16_f32(img: torch.Tensor) -> torch.Tensor:
    """(img / img.max() * 255).astype(np.uint8) (env_lab.py:426-427)."""
    x = img.to(torch.float32)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    return torch.floor(x / torch.clamp(hi, min=1e-20) * 255.0)


def _axis_weights(n_in: int, n_out: int, device):
    scale = n_in / n_out
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = (src - i0).astype(np.float32)
    i0c = np.clip(i0, 0, n_in - 1)       # cv2 clamps the sample window
    i1c = np.clip(i0 + 1, 0, n_in - 1)
    return (torch.as_tensor(i0c, device=device),
            torch.as_tensor(i1c, device=device),
            torch.as_tensor(frac, device=device))


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """cv2.resize(img, (w_out, h_out), INTER_LINEAR) on fp32 (..., H, W)."""
    oh, ow = out_hw
    y0, y1, fy = _axis_weights(img.shape[-2], oh, img.device)
    x0, x1, fx = _axis_weights(img.shape[-1], ow, img.device)
    top = img.index_select(-2, y0)
    bot = img.index_select(-2, y1)
    rows = top + (bot - top) * fy[:, None]
    left = rows.index_select(-1, x0)
    right = rows.index_select(-1, x1)
    return left + (right - left) * fx


def preprocess_depth(raw: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     out_hw: Tuple[int, int] = (128, 160),
                     noise_level: float = 50.0, dtype_in: str = "float",
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full depth ingest chain for a (B, H, W) stack of raw camera frames:
    normalize -> noise -> blur5 -> band blur11 -> resize -> /255. Returns
    the (B, out_h, out_w) states in [0, 1] fed to the policy."""
    if dtype_in == "float":
        x = normalize_depth_f32(raw.to(torch.float32))
    elif dtype_in == "uint16":
        x = normalize_depth_u16_f32(raw)
    else:  # already on the uint8 scale
        x = raw.to(torch.float32)
    x = add_noise(x, generator, noise_level, noise=noise)
    x = band_blur(x, 11)
    x = resize_bilinear(x, out_hw)
    return x / _scalar(255.0, x)


def preprocess_fisheye(raw: torch.Tensor,
                       out_hw: Tuple[int, int] = (128, 160)) -> torch.Tensor:
    """Fisheye ingest (env_lab.py:450-458 + the step's resize): mono8
    (B, H, W) -> crop [80:400, 118:523] -> band blur -> resize -> /255."""
    x = raw.to(torch.float32)[..., 80:400, 118:523]
    x = band_blur(x, 11)
    x = resize_bilinear(x, out_hw)
    return x / _scalar(255.0, x)
