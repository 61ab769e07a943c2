"""The host robustness suite's superpixel occlusion (env_lab.py:49-59).

Counterpart of `dgvit_tpu/envs/faults.py`, host numpy as there: a
self-contained SLIC (the reference calls skimage.slic) and the occlusion
of every superpixel that overlaps the frame's centre band. The other
faults of the suite are tensor functions: `ops/preprocess.py` (noise,
blur, band blur, pixel occlusion, greying) and `envs/fault_aug.py` (the
knobbed family of the sweep and of training-time augmentation).
"""

from __future__ import annotations

import numpy as np


def slic_segments(image: np.ndarray, n_segments: int = 50,
                  compactness: float = 4.0, n_iter: int = 5,
                  start_label: int = 1) -> np.ndarray:
    """Simple SLIC superpixels for a single-channel image (skimage-style
    labels, channel_axis=None semantics like env_lab.py:51)."""
    img = image.astype(np.float64)
    h, w = img.shape
    n = int(n_segments)
    step = int(np.sqrt(h * w / n)) or 1

    ys = np.arange(step // 2, h, step)
    xs = np.arange(step // 2, w, step)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    centers = np.stack([cy.ravel().astype(np.float64),
                        cx.ravel().astype(np.float64)], 1)
    cval = img[cy.ravel(), cx.ravel()].astype(np.float64)
    k = len(centers)

    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    labels = np.zeros((h, w), np.int64)
    # scale intensity distance like skimage: ratio = compactness / step
    m = compactness / step

    for _ in range(n_iter):
        best = np.full((h, w), np.inf)
        for i in range(k):
            y0, x0 = centers[i]
            ylo, yhi = max(0, int(y0) - step), min(h, int(y0) + step + 1)
            xlo, xhi = max(0, int(x0) - step), min(w, int(x0) + step + 1)
            sy, sx = yy[ylo:yhi, xlo:xhi], xx[ylo:yhi, xlo:xhi]
            d_spatial = (sy - y0) ** 2 + (sx - x0) ** 2
            d_color = (img[ylo:yhi, xlo:xhi] - cval[i]) ** 2
            d = d_color + (m ** 2) * d_spatial
            region = best[ylo:yhi, xlo:xhi]
            mask = d < region
            region[mask] = d[mask]
            labels[ylo:yhi, xlo:xhi][mask] = i
        for i in range(k):
            sel = labels == i
            if sel.any():
                centers[i] = (yy[sel].mean(), xx[sel].mean())
                cval[i] = img[sel].mean()
    return labels + start_label


def superpixel_occlusion(image: np.ndarray, segments: int = 50) -> np.ndarray:
    """env_lab.py:49-59: zero every superpixel overlapping the center band."""
    labels = slic_segments(image, n_segments=segments, compactness=4)
    out = image.copy()
    h = image.shape[0]
    band = h // 5
    y1 = h // 2 - band // 2
    y2 = y1 + band
    affected = np.unique(labels[y1:y2, :])
    for seg in affected:
        out[labels == seg] = 0
    return out
