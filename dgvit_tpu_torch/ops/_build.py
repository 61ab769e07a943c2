"""Build and load the port's CUDA kernels.

`csrc/<name>.cu` compiles on first use into a shared library with a plain
C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

and is loaded with ctypes. Libraries land in `kernels/` under the build
root (`core/build_dir.py`: `$DGVIT_TORCH_BUILD_DIR`, else the checkout's
git-ignored `build/`, else the user's cache), named by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source rebuilds and an unchanged one loads at once. `build` compiles several sources at once, one
nvcc each. A failed build raises with the compiler's output. `build` and
`load` hold one process-wide lock, so threads that first launch a kernel
together compile it once, and each compile writes a temporary file named
by its process and thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from dgvit_tpu_torch.core.build_dir import build_root

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = build_root() / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_LOCK = threading.RLock()


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _target(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def build(*names: str) -> None:
    """Compile every named source that has no library yet, all at once."""
    with _LOCK:
        procs = []
        for name in names:
            target = _target(name)
            if target.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            procs.append((name, target, tmp, subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, target, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed on {name}.cu (rc "
                              f"{proc.returncode}):\n{out}")
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, compiled first if it has none."""
    with _LOCK:
        build(name)
        return ctypes.CDLL(str(_target(name)))
