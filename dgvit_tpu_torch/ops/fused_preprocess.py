"""Fused depth ingest (K5) with its plain version.

Counterpart of `dgvit_tpu/ops/pallas_preprocess.py`: a stack of raw
(B, 512, 640) float depth frames becomes the (B, 128, 160) states in
[0, 1] the policy reads, in one pass over each frame:

    min-max normalise to 0..255 with floor -> + sigma * z, clip [0, 255]
    -> 5x5 blur -> 11x11 blur of the centre band -> 4x bilinear -> /255

  * `preprocess_depth_fused` launches the hand-written CUDA kernel of
    `csrc/depth_preprocess.cu` for CUDA tensors (one launch a call: a
    thread-block cluster a frame, the frame read once into the cluster's
    shared memory) and runs `preprocess_depth_plain` for CPU tensors;
    nothing else picks between them, and a build or launch failure
    raises;
  * `preprocess_depth_plain` is the same function in plain PyTorch: the
    chain of `ops/preprocess.py` with the kernel's noise generator;
  * `preprocess_depth_auto` is the package's ingest entry point, as
    `dgvit_tpu.ops.preprocess_depth_auto` is the JAX package's.

Noise. z is Irwin-Hall(12): the sum of 12 bytes taken from three 32-bit
words, (sum - 1530) / 255.998 (exact mean and variance, support +-6
sigma), as in the TPU kernel. The words come from a counter-based
generator written out by hand, the same in the kernel and in
`irwin_hall_noise` bit for bit: with mix the 32-bit integer hash
x ^= x >> 16; x *= 0x7feb352d; x ^= x >> 15; x *= 0x846ca68b; x ^= x >> 16
and key = mix(seed + frame) (32-bit wrap-around), word j of pixel p (its
row-major index in the frame) is mix(mix(p) ^ mix(key + j)). Frame i of a
batch therefore equals the same frame run alone with seed + i. The stream
is neither the TPU generator's nor torch.randn's: compare distributions.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dgvit_tpu_torch.ops import preprocess as pp

H_IN, W_IN = 512, 640
H_OUT, W_OUT = 128, 160
_M32 = 0xFFFFFFFF
_PLAIN_CHUNK = 16   # frames per pass of the plain version (bounds its memory)


def supported_shape(shape) -> bool:
    return tuple(shape[-2:]) == (H_IN, W_IN)


# --------------------------------------------------------------------------
# the generator, in integer tensor ops
# --------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without overflowing."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & _M32) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _byte_sum(w: torch.Tensor) -> torch.Tensor:
    return (w & 255) + ((w >> 8) & 255) + ((w >> 16) & 255) + (w >> 24)


def irwin_hall_noise(seeds: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Irwin-Hall(12) standard-normal-like draws, (len(seeds), h, w) fp32,
    on the device of `seeds` (integer tensor, one seed per frame; only its
    low 32 bits count)."""
    key = _mix32(seeds.to(torch.int64) & _M32)[:, None]
    m = _mix32(torch.arange(h * w, dtype=torch.int64,
                            device=seeds.device))[None, :]
    acc = torch.zeros((key.shape[0], h * w), dtype=torch.int64,
                      device=seeds.device)
    for j in range(3):
        acc = acc + _byte_sum(_mix32(m ^ _mix32((key + j) & _M32)))
    inv_std = torch.tensor(1.0 / 255.9980469, dtype=torch.float32,
                           device=seeds.device)
    z = (acc.to(torch.float32) - 1530.0) * inv_std
    return z.reshape(-1, h, w)


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _check(raw: torch.Tensor) -> None:
    if raw.dim() != 3 or not supported_shape(raw.shape):
        raise ValueError(f"raw of shape {tuple(raw.shape)}: the fused depth "
                         f"ingest takes (B, {H_IN}, {W_IN}) frames")
    if raw.shape[0] < 1:
        raise ValueError("an empty batch of frames")


def _seed32(seed) -> int:
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return seed & _M32


def preprocess_depth_plain(raw: torch.Tensor, seed: int,
                           noise_level: float = 50.0) -> torch.Tensor:
    """Plain PyTorch version of K5, on any device: (B, 512, 640) ->
    (B, 128, 160) fp32. Frame i draws its noise with seed + i."""
    _check(raw)
    seed = _seed32(seed)
    outs = []
    for s in range(0, raw.shape[0], _PLAIN_CHUNK):
        x = pp.normalize_depth_f32(raw[s:s + _PLAIN_CHUNK].to(torch.float32))
        if noise_level > 0.0:
            seeds = seed + s + torch.arange(x.shape[0], device=x.device)
            x = torch.clamp(
                x + noise_level * irwin_hall_noise(seeds, H_IN, W_IN),
                0.0, 255.0)
        x = pp.band_blur(pp.gaussian_blur(x, 5), 11)
        x = pp.resize_bilinear(x, (H_OUT, W_OUT))
        outs.append(x / pp._scalar(255.0, x))
    return torch.cat(outs)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built and
    loaded at the first launch, never at import)."""
    from dgvit_tpu_torch.ops import _build

    lib = _build.load("depth_preprocess")
    lib.depth_preprocess_launch.restype = ctypes.c_int
    lib.depth_preprocess_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    lib.depth_preprocess_occupancy.restype = ctypes.c_int
    lib.depth_preprocess_occupancy.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_int)]
    lib.depth_preprocess_error_string.restype = ctypes.c_char_p
    lib.depth_preprocess_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _taps():
    k = np.concatenate([pp.gaussian_kernel_1d(5), pp.gaussian_kernel_1d(11)]
                       ).astype(np.float32)
    return (ctypes.c_float * len(k))(*k.tolist())


def _launch(raw: torch.Tensor, seed: int, noise_level: float
            ) -> torch.Tensor:
    lib = _kernel_lib()
    b = raw.shape[0]
    out = torch.empty((b, H_OUT, W_OUT), dtype=torch.float32,
                      device=raw.device)
    signed = seed - 2 ** 32 if seed >= 2 ** 31 else seed
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.depth_preprocess_launch(
            raw.data_ptr(), out.data_ptr(), b, signed, float(noise_level),
            _taps(), stream)
    if err != 0:
        raise RuntimeError("depth_preprocess launch failed: "
                           + lib.depth_preprocess_error_string(err).decode())
    preprocess_depth_fused.launches += 1
    return out


def kernel_occupancy():
    """(CTAs of a frame's cluster, bytes of shared memory a CTA asks for,
    clusters the current card holds at once or None where the query
    fails)."""
    lib = _kernel_lib()
    ranks, nbytes, clusters = ctypes.c_int(), ctypes.c_size_t(), ctypes.c_int()
    err = lib.depth_preprocess_occupancy(
        ctypes.byref(ranks), ctypes.byref(nbytes), ctypes.byref(clusters))
    return ranks.value, nbytes.value, clusters.value if err == 0 else None


def preprocess_depth_fused(raw: torch.Tensor, seed: int,
                           noise_level: float = 50.0) -> torch.Tensor:
    """Fused depth ingest: (B, 512, 640) raw float depth -> (B, 128, 160)
    fp32 states in [0, 1]. `seed` is a 32-bit integer; frame i uses
    seed + i. `noise_level` is the noise's sigma on the 0..255 scale (0:
    no noise).

    CUDA tensors go to the CUDA kernel (fp32, contiguous, 16-byte
    aligned; raises if it cannot run); CPU tensors go to the plain
    version. `preprocess_depth_fused.launches` counts calls that launched
    the kernel (one CUDA launch each)."""
    _check(raw)
    seed = _seed32(seed)
    if noise_level < 0.0:
        raise ValueError(f"noise_level {noise_level} < 0")
    if raw.device.type == "cuda":
        if raw.dtype != torch.float32:
            raise TypeError(f"raw of dtype {raw.dtype}: the kernel takes "
                            "fp32 frames")
        if not raw.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
        if raw.data_ptr() % 16:
            raise ValueError("the kernel takes frames on a 16-byte "
                             "boundary (its bulk copies)")
        return _launch(raw, seed, noise_level)
    if raw.device.type != "cpu":
        raise ValueError(f"no kernel for device {raw.device}")
    return preprocess_depth_plain(raw, seed, noise_level)


preprocess_depth_fused.launches = 0


def preprocess_depth_auto(raw: torch.Tensor, seed: int,
                          noise_level: float = 50.0) -> torch.Tensor:
    """The ingest entry point (`dgvit_tpu.ops.preprocess_depth_auto`): on a
    CUDA stack of the live 512x640 geometry, the fused kernel (another
    geometry on the card raises: call `ops.preprocess.preprocess_depth`
    for it); on a CPU stack, the plain chain `preprocess_depth` with a
    generator seeded from `seed`, as the JAX entry runs its XLA chain off
    the TPU."""
    if raw.device.type == "cuda":
        if not supported_shape(raw.shape):
            raise ValueError(
                f"raw of shape {tuple(raw.shape)} on {raw.device}: the "
                f"kernel is specialised to {H_IN}x{W_IN} frames")
        return preprocess_depth_fused(raw, seed, noise_level)
    gen = torch.Generator(raw.device).manual_seed(_seed32(seed))
    return pp.preprocess_depth(raw, gen, noise_level=noise_level)
