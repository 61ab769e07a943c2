"""Flat parameter files written by the JAX package's `save_params_npz`:
one npz entry per leaf, keyed by the '/'-joined tree path
(e.g. 'trans/transformer/block_0/attn/to_qkv/kernel')."""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """Read every entry of a flat params npz into a {path: array} dict."""
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}
