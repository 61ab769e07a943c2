"""Python wrapper over the C++ prioritized ring buffer (csrc/replay.cpp).

Host code, a copy of `dgvit_tpu/replay/buffer.py` over the port's own copy
of the C++ core. The core is compiled with the host C++ compiler at first
use into `replay/` under the build root (`core/build_dir.py`:
`$DGVIT_TORCH_BUILD_DIR`, else the checkout's git-ignored `build/`, else
the user's cache), named by a hash of the source; no library is checked
in.

API mirrors the cpprb usage in the reference (DRL.py:80-100,375,438-477,
505-510): schema dict of named fields, `add(**fields)`, `sample(n) -> dict`,
`get_stored_size()`, `save_transitions`/`load_transitions` npz persistence.

Sampling is uniform by default — the reference constructs Prioritized buffers
but never updates priorities, so cpprb's proportional sampler degenerates to
uniform (SURVEY.md §2.2). `prioritized=True` enables the real sum-tree PER
path (proportional sampling + importance weights + update_priorities).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from dgvit_tpu_torch.core.build_dir import build_root

_SRC = Path(__file__).resolve().parent / "csrc" / "replay.cpp"
_BUILD_DIR = build_root() / "replay"
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]


def _build_lib() -> Path:
    """Compile csrc/replay.cpp unless its library is there already."""
    tag = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(_CXXFLAGS).encode()).hexdigest()[:16]
    target = _BUILD_DIR / f"libreplay-{tag}.so"
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (c++ or g++): the replay "
                           "buffer's core builds at first use")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on replay.cpp (rc "
                           f"{res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, target)
    return target


@functools.cache
def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build_lib()))
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_int64, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.c_double, ctypes.c_uint64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_stored_size.argtypes = [ctypes.c_void_p]
    lib.rb_stored_size.restype = ctypes.c_int64
    lib.rb_capacity.argtypes = [ctypes.c_void_p]
    lib.rb_capacity.restype = ctypes.c_int64
    lib.rb_cursor.argtypes = [ctypes.c_void_p]
    lib.rb_cursor.restype = ctypes.c_int64
    lib.rb_add.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_void_p)]
    lib.rb_sample_uniform.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int64)]
    lib.rb_sample_prioritized.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)]
    lib.rb_update_priorities.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double)]
    lib.rb_gather.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
    lib.rb_export.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    return lib


def _normalize_schema(schema: Dict) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    out = {}
    for name, spec in schema.items():
        shape = tuple(spec.get("shape", ())) if isinstance(spec, dict) else tuple(spec)
        if isinstance(shape, int):
            shape = (shape,)
        dtype = np.dtype(spec.get("dtype", np.float32)) if isinstance(spec, dict) \
            else np.float32
        out[name] = (shape, dtype)
    return out


class ReplayBuffer:
    """Uniform-sampling multi-field ring buffer."""

    prioritized = False

    def __init__(self, capacity: int, schema: Dict, seed: int = 0,
                 alpha: float = 0.6):
        self._lib = _load_lib()
        # the C++ core is single-threaded by design; this lock serializes it
        # so a BatchPrefetcher thread can sample while the env loop adds
        self._lock = threading.Lock()
        self.capacity = int(capacity)
        self.schema = _normalize_schema(schema)
        self._names = list(self.schema)
        nbytes = (ctypes.c_int64 * len(self._names))(*[
            int(np.prod(shape, dtype=np.int64) or 1) * dtype.itemsize
            for shape, dtype in self.schema.values()
        ])
        self._h = self._lib.rb_create(self.capacity, len(self._names), nbytes,
                                      alpha, seed)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None

    # -- writes ------------------------------------------------------------
    def add(self, **fields):
        """Add one transition or a batch (leading dim). cpprb-style kwargs."""
        missing = set(self._names) - set(fields)
        if missing:
            raise KeyError(f"missing fields {sorted(missing)}")
        arrs = []
        n = None
        for name in self._names:
            shape, dtype = self.schema[name]
            a = np.ascontiguousarray(fields[name], dtype=dtype)
            if a.shape == shape:
                a = a[None]
            elif a.shape[1:] != shape:
                # allow scalars fed as python numbers / (n,) for shape ()
                if shape == () and a.ndim <= 1:
                    a = a.reshape(-1)
                else:
                    raise ValueError(
                        f"field {name!r}: got {a.shape}, want (n,)+{shape}")
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError(f"field {name!r}: batch {a.shape[0]} != {n}")
            arrs.append(a)
        ptrs = (ctypes.c_void_p * len(arrs))(*[
            a.ctypes.data_as(ctypes.c_void_p).value for a in arrs])
        with self._lock:
            self._lib.rb_add(self._h, n, ptrs)
        return n

    # -- reads -------------------------------------------------------------
    def get_stored_size(self) -> int:
        return int(self._lib.rb_stored_size(self._h))

    def _gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        n = len(idx)
        idx_c = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        out = {}
        for f, name in enumerate(self._names):
            shape, dtype = self.schema[name]
            buf = np.empty((n,) + shape, dtype=dtype)
            self._lib.rb_gather(self._h, f, n, idx_c,
                                buf.ctypes.data_as(ctypes.c_void_p))
            # cpprb returns (n, 1) for scalar fields
            out[name] = buf.reshape(n, 1) if shape == () else buf
        return out

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        with self._lock:
            stored = int(self._lib.rb_stored_size(self._h))
            if stored == 0:
                raise ValueError("empty buffer")
            idx = np.empty(batch_size, np.int64)
            self._lib.rb_sample_uniform(
                self._h, batch_size,
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            return self._gather(idx)

    # -- persistence (cpprb save/load_transitions, DRL.py:505-510) ----------
    def save_transitions(self, file: str):
        stored = self.get_stored_size()
        data = {}
        for f, name in enumerate(self._names):
            shape, dtype = self.schema[name]
            buf = np.empty((stored,) + shape, dtype=dtype)
            self._lib.rb_export(self._h, f, buf.ctypes.data_as(ctypes.c_void_p))
            data[name] = buf
        path = file if str(file).endswith(".npz") else f"{file}.npz"
        np.savez_compressed(path, **data)

    def load_transitions(self, file: str):
        d = np.load(file)
        self.add(**{k: d[k] for k in self._names})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Sum-tree proportional PER. sample() returns `weights` and `indexes`
    alongside the fields (cpprb PER API)."""

    prioritized = True

    def sample(self, batch_size: int, beta: float = 0.4) -> Dict[str, np.ndarray]:
        with self._lock:
            stored = int(self._lib.rb_stored_size(self._h))
            if stored == 0:
                raise ValueError("empty buffer")
            idx = np.empty(batch_size, np.int64)
            w = np.empty(batch_size, np.float64)
            self._lib.rb_sample_prioritized(
                self._h, batch_size, beta,
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            out = self._gather(idx)
        out["weights"] = w.astype(np.float32)
        out["indexes"] = idx
        return out

    def update_priorities(self, indexes: np.ndarray, priorities: np.ndarray):
        idx = np.ascontiguousarray(indexes, np.int64)
        pr = np.ascontiguousarray(priorities, np.float64)
        with self._lock:
            self._update_priorities_locked(idx, pr)

    def _update_priorities_locked(self, idx, pr):
        self._lib.rb_update_priorities(
            self._h, len(idx),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            pr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))


def reference_schema(obs_shape=(128, 160), action_dim=2, pstate_dim=2,
                     expert: bool = False) -> Dict:
    """The exact field layout of DRL.py:80-100."""
    act_key = "act_exp" if expert else "act"
    schema = {
        "obs": {"shape": obs_shape},
        act_key: {"shape": (action_dim,)},
        "pobs": {"shape": (pstate_dim,)},
        "next_pobs": {"shape": (pstate_dim,)},
        "rew": {"shape": ()},
        "next_obs": {"shape": obs_shape},
        "done": {"shape": ()},
    }
    if not expert:
        schema["engage"] = {"shape": ()}
    return schema
