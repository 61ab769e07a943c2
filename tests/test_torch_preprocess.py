"""The port's depth ingest (dgvit_tpu_torch/ops/preprocess.py and
ops/fused_preprocess.py) against the JAX package's, on the CPU.

Every function of ops/preprocess.py runs on numpy-seeded inputs beside its
JAX twin. Tolerances, fp32 on both sides:
  * functions on the 0..255 scale: 2e-5 abs (fp32 has 1.5e-5 between
    neighbours above 128, and XLA may contract a tap's product and sum
    where PyTorch rounds each);
  * `resize_bilinear` at a non-integer scale: 1e-4 abs on the 0..255
    scale (a + (b - a) * f rounds a difference of up to 255 twice, XLA
    once where it contracts the product and sum; that is 4e-7 of the
    range);
  * outputs in [0, 1] (`preprocess_depth`, `preprocess_fisheye`): 1e-5 abs;
  * noise is compared with the JAX package's own draws handed to the port
    (`noise=`), and at sigma = 0.
The plain version of the fused kernel (`preprocess_depth_plain`) is held
at sigma = 0 against the Pallas kernel in interpret mode and against the
JAX chain with the limits of tests/test_pallas_preprocess.py (max <=
1.2/255 for a floor() flipped at a u8 boundary, under 2% of pixels over
1e-4), and its generator by its statistics, determinism and
frame-alone = frame-in-batch. On a CPU tensor the kernel's wrapper runs
that plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.ops import pallas_preprocess as jpp
from dgvit_tpu.ops import preprocess as jp
from dgvit_tpu_torch import ops as port_ops
from dgvit_tpu_torch.ops import fused_preprocess as fp
from dgvit_tpu_torch.ops import preprocess as pp

TOL_255 = 2e-5
TOL_RESIZE = 1e-4
TOL_UNIT = 1e-5


def frames(seed, *shape, lo=0.0, hi=255.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def close(port, ref, tol):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    assert np.abs(port - ref).max() <= tol


@pytest.mark.parametrize("ksize,sigma", [(1, 0.0), (3, 0.0), (5, 0.0),
                                         (7, 0.0), (11, 0.0), (9, 1.7),
                                         (5, 2.0)])
def test_gaussian_kernel_1d(ksize, sigma):
    np.testing.assert_array_equal(pp.gaussian_kernel_1d(ksize, sigma),
                                  jp.gaussian_kernel_1d(ksize, sigma))


@pytest.mark.parametrize("ksize", [3, 5, 11])
@pytest.mark.parametrize("shape", [(2, 24, 30), (17, 13)])
def test_gaussian_blur(ksize, shape):
    x = frames(ksize, *shape)
    close(pp.gaussian_blur(torch.from_numpy(x), ksize),
          jp.gaussian_blur(jnp.asarray(x), ksize), TOL_255)


@pytest.mark.parametrize("h", [5, 64, 128, 320, 512])
def test_center_band(h):
    assert pp.center_band(h) == jp.center_band(h)


@pytest.mark.parametrize("shape", [(3, 60, 40), (128, 32)])
def test_band_blur(shape):
    x = frames(1, *shape)
    close(pp.band_blur(torch.from_numpy(x), 11),
          jp.band_blur(jnp.asarray(x), 11), TOL_255)


@pytest.mark.parametrize("fn", ["pixel_occlusion", "greying_out"])
def test_band_paint(fn):
    x = frames(2, 2, 50, 20)
    out = getattr(pp, fn)(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(getattr(jp, fn)(jnp.asarray(x))))


def test_greying_out_keeps_dtype():
    x = np.random.default_rng(0).integers(0, 255, (40, 20)).astype(np.uint8)
    out = pp.greying_out(torch.from_numpy(x))
    ref = np.asarray(jp.greying_out(jnp.asarray(x)))
    assert out.numpy().dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("sigma", [0.0, 50.0])
def test_add_noise_with_the_jax_draws(sigma):
    x = frames(3, 2, 40, 48)
    key = jax.random.PRNGKey(5)
    z = np.array(jax.random.normal(key, x.shape, jnp.float32))
    close(pp.add_noise(torch.from_numpy(x), None, sigma,
                       noise=torch.from_numpy(z)),
          jp.add_noise(jnp.asarray(x), key, sigma), TOL_255)


def test_add_noise_draws_from_the_generator():
    x = torch.from_numpy(frames(4, 2, 64, 64, lo=100.0, hi=150.0))
    g = lambda s: torch.Generator().manual_seed(s)
    a, b, c = (pp.add_noise(x, g(s), 20.0) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # sigma 20 through the 5x5 binomial blur: sqrt(sum of squared taps)
    want = 20.0 * float((np.outer(pp.gaussian_kernel_1d(5),
                                  pp.gaussian_kernel_1d(5)) ** 2).sum()) ** .5
    noise = a - pp.gaussian_blur(x, 5)
    assert abs(noise.mean().item()) < 0.3
    assert abs(noise.std().item() - want) < 0.3


@pytest.mark.parametrize("case", ["uniform", "constant", "negative", "wide"])
def test_normalize_depth_f32(case):
    x = {"uniform": frames(5, 3, 32, 40, lo=0.3, hi=8.0),
         "constant": np.full((2, 16, 16), 3.5, np.float32),
         "negative": frames(6, 2, 20, 20, lo=-5.0, hi=5.0),
         "wide": frames(7, 2, 20, 20, lo=-1e30, hi=1e30)}[case]
    out = pp.normalize_depth_f32(torch.from_numpy(x)).numpy()
    ref = np.asarray(jp.normalize_depth_f32(jnp.asarray(x)))
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, ref)


def test_normalize_depth_u16():
    x = np.random.default_rng(8).integers(0, 65535, (2, 24, 24)).astype(
        np.uint16)
    out = pp.normalize_depth_u16_f32(torch.from_numpy(x.astype(np.int32)))
    ref = np.asarray(jp.normalize_depth_u16_f32(jnp.asarray(x)))
    # x / hi * 255 may land a rounding apart at an integer: one u8 step
    d = np.abs(out.numpy() - ref)
    assert d.max() <= 1.0 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("in_hw,out_hw", [((512, 640), (128, 160)),
                                          ((320, 405), (128, 160)),
                                          ((30, 50), (45, 20)),
                                          ((16, 16), (16, 16))])
def test_resize_bilinear(in_hw, out_hw):
    x = frames(9, 2, *in_hw)
    close(pp.resize_bilinear(torch.from_numpy(x), out_hw),
          jp.resize_bilinear(jnp.asarray(x), out_hw), TOL_RESIZE)


@pytest.mark.parametrize("dtype_in", ["float", "uint16", "uint8"])
@pytest.mark.parametrize("sigma", [0.0, 50.0])
def test_preprocess_depth(dtype_in, sigma):
    rng = np.random.default_rng(10)
    if dtype_in == "float":
        raw = rng.uniform(0.3, 8.0, (2, 120, 160)).astype(np.float32)
        traw = torch.from_numpy(raw)
    elif dtype_in == "uint16":
        raw = rng.integers(0, 65535, (2, 120, 160)).astype(np.uint16)
        traw = torch.from_numpy(raw.astype(np.int32))
    else:
        raw = rng.integers(0, 255, (2, 120, 160)).astype(np.uint8)
        traw = torch.from_numpy(raw)
    key = jax.random.PRNGKey(11)
    z = np.array(jax.random.normal(key, raw.shape, jnp.float32))
    out = pp.preprocess_depth(traw, None, (32, 40), sigma, dtype_in,
                              noise=torch.from_numpy(z))
    ref = jp.preprocess_depth(jnp.asarray(raw), key, (32, 40), sigma,
                              dtype_in)
    assert out.shape == (2, 32, 40)
    d = np.abs(out.numpy() - np.asarray(ref))
    if dtype_in == "uint16":
        # a u8 step flipped by x / hi * 255 (see test_normalize_depth_u16)
        assert d.max() <= 1.2 / 255.0 and (d > TOL_UNIT).mean() < 0.01
    else:
        assert d.max() <= TOL_UNIT


def test_preprocess_fisheye():
    raw = np.random.default_rng(12).integers(0, 255, (2, 480, 640)).astype(
        np.uint8)
    close(pp.preprocess_fisheye(torch.from_numpy(raw)),
          jp.preprocess_fisheye(jnp.asarray(raw)), TOL_UNIT)


# --------------------------------------------------------------------------
# the fused kernel's plain version
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raw():
    return np.random.default_rng(3).uniform(0.3, 8.0, (2, 512, 640)).astype(
        np.float32)


def test_supported_shape():
    assert fp.supported_shape((4, 512, 640))
    assert not fp.supported_shape((4, 320, 405))
    assert fp.supported_shape((512, 640)) == jpp.supported_shape((512, 640))


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_chain"])
def test_plain_sigma0_matches_jax(raw, ref):
    ours = fp.preprocess_depth_plain(torch.from_numpy(raw), 0, 0.0).numpy()
    if ref == "pallas_interpret":
        want = jpp.preprocess_depth_pallas(jnp.asarray(raw), jnp.int32(0),
                                           noise_level=0.0, interpret=True)
    else:
        want = jp.preprocess_depth(jnp.asarray(raw), jax.random.PRNGKey(0),
                                   noise_level=0.0)
    assert ours.shape == (2, 128, 160) and ours.dtype == np.float32
    diff = np.abs(ours - np.asarray(want))
    assert diff.max() <= 1.2 / 255.0
    assert (diff > 1e-4).mean() < 0.02


def test_plain_is_the_preprocess_chain(raw):
    """The plain version is ops/preprocess.py's chain with the kernel's
    generator: the same bits as the chain fed that noise."""
    x = torch.from_numpy(raw)
    for sigma in (0.0, 50.0):
        z = fp.irwin_hall_noise(torch.tensor([7, 8]), 512, 640)
        want = pp.preprocess_depth(x, None, noise_level=sigma, noise=z)
        assert torch.equal(fp.preprocess_depth_plain(x, 7, sigma), want)


def test_generator_statistics():
    z = fp.irwin_hall_noise(torch.tensor([11]), 512, 640)
    assert z.shape == (1, 512, 640) and z.dtype == torch.float32
    assert abs(z.mean().item()) < 0.01
    assert abs(z.std().item() - 1.0) < 0.01
    assert z.abs().max().item() <= 6.0
    # Irwin-Hall(12) has excess kurtosis -0.1
    assert abs(((z ** 4).mean() / (z ** 2).mean() ** 2).item() - 2.9) < 0.05
    # no correlation between neighbours, along rows or columns
    zc = z[0] - z.mean()
    assert abs((zc[:, 1:] * zc[:, :-1]).mean().item()) < 0.01
    assert abs((zc[1:] * zc[:-1]).mean().item()) < 0.01


def test_generator_matches_its_definition():
    """irwin_hall_noise against the generator written out in numpy uint32
    arithmetic (the CUDA kernel's own form)."""
    u = np.uint32

    def mix(x):
        x = x.astype(u)
        x ^= x >> u(16)
        x = x * u(0x7FEB352D)
        x ^= x >> u(15)
        x = x * u(0x846CA68B)
        return x ^ (x >> u(16))

    h, w = 8, 10
    for seed in (0, 5, 2 ** 32 - 1):
        key = mix(np.array([seed], u))
        m = mix(np.arange(h * w, dtype=u))
        acc = np.zeros(h * w, np.int64)
        for j in range(3):
            word = mix(m ^ mix(key + u(j)))
            for sh in (0, 8, 16, 24):
                acc += ((word >> u(sh)) & u(255)).astype(np.int64)
        want = ((acc.astype(np.float32) - np.float32(1530.0))
                * np.float32(1.0 / 255.9980469)).reshape(1, h, w)
        got = fp.irwin_hall_noise(torch.tensor([seed]), h, w).numpy()
        np.testing.assert_array_equal(got, want)


def test_noise_statistics_match_the_randn_chain(raw):
    out = fp.preprocess_depth_plain(torch.from_numpy(raw), 7, 50.0)
    ref = pp.preprocess_depth(torch.from_numpy(raw),
                              torch.Generator().manual_seed(7),
                              noise_level=50.0)
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert abs(out.mean().item() - ref.mean().item()) < 0.01
    assert abs(out.std().item() - ref.std().item()) < 0.01
    assert not torch.allclose(out[0], out[1])


def test_seed_determinism_and_frame_alone(raw):
    x = torch.from_numpy(raw)
    a = fp.preprocess_depth_plain(x, 3, 50.0)
    b = fp.preprocess_depth_plain(x, 3, 50.0)
    c = fp.preprocess_depth_plain(x, 4, 50.0)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    # frame i of a batch is the same frame run alone with seed + i
    alone = fp.preprocess_depth_plain(x[1:], 4, 50.0)
    assert torch.equal(alone[0], a[1])
    # the seed wraps at 32 bits, as the kernel's does
    wrap = fp.preprocess_depth_plain(x, 2 ** 32 - 1, 50.0)
    zero = fp.preprocess_depth_plain(x[1:], 0, 50.0)
    assert torch.equal(wrap[1], zero[0])
    assert torch.equal(fp.preprocess_depth_plain(x[:1], -1, 50.0), wrap[:1])


def test_constant_and_extreme_frames():
    const = torch.full((1, 512, 640), 2.5)
    out = fp.preprocess_depth_plain(const, 0, 0.0)
    assert torch.equal(out, torch.zeros(1, 128, 160))
    wide = torch.from_numpy(frames(13, 1, 512, 640, lo=-1e30, hi=1e30))
    out = fp.preprocess_depth_plain(wide, 0, 50.0)
    assert bool(torch.isfinite(out).all())
    assert out.min() >= 0.0 and out.max() <= 1.0


def test_wrapper_on_cpu_runs_the_plain_version(raw):
    x = torch.from_numpy(raw[:1])
    before = fp.preprocess_depth_fused.launches
    out = fp.preprocess_depth_fused(x, 9, 50.0)
    assert fp.preprocess_depth_fused.launches == before
    assert torch.equal(out, fp.preprocess_depth_plain(x, 9, 50.0))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="512"):
        fp.preprocess_depth_fused(torch.zeros(2, 320, 405), 0)
    with pytest.raises(ValueError, match="512"):
        fp.preprocess_depth_fused(torch.zeros(512, 640), 0)
    with pytest.raises(ValueError, match="32 bits"):
        fp.preprocess_depth_fused(torch.zeros(1, 512, 640), 2 ** 40)
    with pytest.raises(ValueError, match="noise_level"):
        fp.preprocess_depth_fused(torch.zeros(1, 512, 640), 0, -1.0)


def test_auto_on_cpu_is_the_plain_chain(raw):
    """Off the card the entry point runs `preprocess_depth` with a
    generator seeded from `seed`, on any geometry, as the JAX entry runs
    its XLA chain off the TPU."""
    assert port_ops.preprocess_depth_auto is fp.preprocess_depth_auto
    x = torch.from_numpy(raw[:1])
    out = fp.preprocess_depth_auto(x, 5, 50.0)
    want = pp.preprocess_depth(x, torch.Generator().manual_seed(5),
                               noise_level=50.0)
    assert torch.equal(out, want)
    small = torch.from_numpy(frames(14, 2, 64, 80, lo=0.3, hi=8.0))
    out = fp.preprocess_depth_auto(small, 1, 0.0)
    ref = jpp.preprocess_depth_auto(jnp.asarray(small.numpy()), 1, 0.0)
    close(out, ref, TOL_UNIT)
