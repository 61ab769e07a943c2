"""The port's host robustness suite (dgvit_tpu_torch/envs/faults.py)
against the JAX package's `envs/faults.py`: SLIC superpixels and the
superpixel occlusion of the centre band, host numpy in both, so every
output is held equal element for element. The cases of
tests/test_aux.py:37 and tests/test_aux2.py:75,97 are mirrored; the two
skimage ones skip where scikit-image is absent, as those do.
"""

import numpy as np
import pytest

from dgvit_tpu.envs import faults as jfaults
from dgvit_tpu_torch.envs.faults import slic_segments, superpixel_occlusion


def gradient_image(h=64, w=80):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return (yy * 2.0 + xx * 1.5).astype(np.float32)


def test_image(h=64, w=80, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    img = 0.5 * yy + 0.3 * np.sin(6 * xx) + 0.05 * rng.normal(size=(h, w))
    return (255 * (img - img.min()) / (np.ptp(img) + 1e-9)).astype(
        np.float32)


test_image.__test__ = False


def test_superpixel_occlusion_properties():
    img = gradient_image()
    labels = slic_segments(img, n_segments=20)
    assert labels.shape == img.shape
    assert labels.min() >= 1
    assert 5 <= len(np.unique(labels)) <= 40
    out = superpixel_occlusion(img, segments=20)
    h = img.shape[0]
    band = h // 5
    y1 = h // 2 - band // 2
    assert (out[y1:y1 + band] == 0).all()
    assert (out != 0).any()


IMAGES = {"gradient": gradient_image, "noisy": lambda: test_image(seed=1),
          "depth128": lambda: test_image(128, 160, seed=3) / 255.0,
          "odd": lambda: test_image(37, 53, seed=4)}


@pytest.mark.parametrize("segments", [20, 50])
@pytest.mark.parametrize("image", list(IMAGES))
def test_slic_segments_equal_jax(image, segments):
    img = IMAGES[image]()
    np.testing.assert_array_equal(
        slic_segments(img, n_segments=segments, compactness=4),
        jfaults.slic_segments(img, n_segments=segments, compactness=4))


@pytest.mark.parametrize("image", list(IMAGES))
def test_superpixel_occlusion_equal_jax(image):
    img = IMAGES[image]()
    out = superpixel_occlusion(img, segments=50)
    np.testing.assert_array_equal(out, jfaults.superpixel_occlusion(img, 50))
    assert out.dtype == img.dtype


def test_slic_segments_close_to_skimage():
    pytest.importorskip("skimage", reason="scikit-image not installed")
    from skimage.segmentation import slic as sk_slic

    img = test_image()
    ours = slic_segments(img, n_segments=50, compactness=4)
    ref = sk_slic(img, n_segments=50, compactness=4, channel_axis=None,
                  start_label=1)
    assert 0.5 * len(np.unique(ref)) <= len(np.unique(ours)) \
        <= 2.0 * len(np.unique(ref))
    rng = np.random.default_rng(1)
    flat_o, flat_r = ours.ravel(), ref.ravel()
    i = rng.integers(0, flat_o.size, 4000)
    j = rng.integers(0, flat_o.size, 4000)
    rand_index = np.mean((flat_o[i] == flat_o[j]) == (flat_r[i] == flat_r[j]))
    assert rand_index > 0.85, f"segmentations diverge: RI={rand_index:.3f}"


def test_superpixel_occlusion_band_fraction_close_to_skimage():
    pytest.importorskip("skimage", reason="scikit-image not installed")
    from skimage.segmentation import slic as sk_slic

    img = test_image(seed=2) + 1.0
    ours = superpixel_occlusion(img, segments=50)
    labels = sk_slic(img, n_segments=50, compactness=4, channel_axis=None,
                     start_label=1)
    h = img.shape[0]
    band = h // 5
    y1 = h // 2 - band // 2
    ref = img.copy()
    for seg in np.unique(labels[y1:y1 + band, :]):
        ref[labels == seg] = 0
    assert np.mean(ours == 0) > 0.15
    assert abs(np.mean(ours == 0) - np.mean(ref == 0)) < 0.25
