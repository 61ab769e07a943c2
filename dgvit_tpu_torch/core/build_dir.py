"""Where the port builds its native code at first use: the CUDA kernels
(`ops/_build.py`, into `<root>/kernels`) and the replay buffer's C++ core
(`replay/buffer.py`, into `<root>/replay`).

The root is `$DGVIT_TORCH_BUILD_DIR` when it is set; else, run from a
checkout (the package beside the repository's `setup.py`), the checkout's
git-ignored `build/`; else, an installed package, the user's cache
directory (`$XDG_CACHE_HOME/dgvit_tpu_torch`, by default
`~/.cache/dgvit_tpu_torch`): an installed package's own directory may not
be writable.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "DGVIT_TORCH_BUILD_DIR"
_CHECKOUT = Path(__file__).resolve().parents[2]


def build_root() -> Path:
    """The directory the native libraries are built into (see above)."""
    if os.environ.get(ENV):
        return Path(os.environ[ENV]).expanduser()
    if (_CHECKOUT / "setup.py").is_file():
        return _CHECKOUT / "build"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "dgvit_tpu_torch"
