"""The kernel build (dgvit_tpu_torch/ops/_build.py) from several threads.

A fake `nvcc` on the PATH stands in for the CUDA toolkit: it logs each
call, waits a little (so a second thread arrives while the first
compiles) and links an empty shared library with the host C++ compiler.
Two threads that load one source at once must compile it once and both
get the library; an edited source builds again. Then what an installed
package carries (setup.py's package_data) and where the native code
builds (core/build_dir.py)."""

import ast
import fnmatch
import os
import re
import shutil
import stat
import sys
import threading
import time
from pathlib import Path

import pytest

from dgvit_tpu_torch.ops import _build

FAKE_NVCC = """#!{python}
import subprocess, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(sys.argv[-1] + "\\n")
time.sleep(0.3)
sys.exit(subprocess.run(["{cxx}", "-shared", "-fPIC", "-x", "c++",
                         "/dev/null", "-o", out]).returncode)
"""


@pytest.fixture()
def fake_toolkit(tmp_path, monkeypatch):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to stand in for nvcc")
    bin_dir, csrc = tmp_path / "bin", tmp_path / "csrc"
    bin_dir.mkdir()
    csrc.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                     cxx=cxx))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    (csrc / "demo.cu").write_text("// a kernel source\n")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    return log, csrc


def calls(log):
    return log.read_text().splitlines() if log.exists() else []


def test_two_threads_loading_one_source_compile_it_once(fake_toolkit):
    log, csrc = fake_toolkit
    libs, errors = [], []
    start = threading.Barrier(2)

    def first_use():
        start.wait()
        try:
            libs.append(_build.load("demo"))
        except Exception as exc:     # reported below, not lost in a thread
            errors.append(exc)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert errors == [] and len(libs) == 2
    assert calls(log) == [str(csrc / "demo.cu")]
    built = list((_build.BUILD_DIR).iterdir())
    assert [p.name for p in built] == [_build._target("demo").name]
    # a loaded library loads again without a compile
    _build.load("demo")
    assert len(calls(log)) == 1
    # an edited source builds anew
    time.sleep(0.01)
    (csrc / "demo.cu").write_text("// the kernel source, edited\n")
    _build.load("demo")
    assert len(calls(log)) == 2


def test_temporary_names_differ_by_thread(fake_toolkit, monkeypatch):
    """Each compile writes its own temporary file: the name carries the
    process and the thread."""
    seen = []
    real = _build.subprocess.Popen

    def spy(cmd, **kw):
        seen.append(cmd[cmd.index("-o") + 1])
        return real(cmd, **kw)

    monkeypatch.setattr(_build.subprocess, "Popen", spy)
    done = []

    def compile_one():
        _build.build("demo")
        done.append(threading.get_ident())

    t = threading.Thread(target=compile_one)
    t.start()
    t.join(60)
    assert len(seen) == 1
    assert seen[0].endswith(f".{os.getpid()}.{done[0]}.tmp")
    _build.build("demo")         # built: no second compile
    assert len(seen) == 1


# ---- what an installed package carries, and where it builds -------------

ROOT = Path(__file__).resolve().parents[1]


def package_data():
    """setup.py's package_data, read with ast (setup() is not run)."""
    tree = ast.parse((ROOT / "setup.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "setup")
    kw = next(k for k in call.keywords if k.arg == "package_data")
    return ast.literal_eval(kw.value)


def shipped(data, path):
    """Whether `path` (relative to the repository) matches a glob of the
    package that holds it."""
    for pkg, globs in data.items():
        base = pkg.replace(".", "/") + "/"
        rel = path.as_posix()
        if rel.startswith(base) and any(
                fnmatch.fnmatch(rel[len(base):], g) for g in globs):
            return True
    return False


def test_package_data_ships_every_native_source_and_include():
    """Every kernel source, every header a source includes (`#include
    "..."`) and the replay core's source match a package_data glob, so an
    installed port can build its kernels and its replay buffer; the JAX
    package's entries stay as they were."""
    data = package_data()
    assert data["dgvit_tpu.replay"] == ["csrc/*.cpp", "csrc/Makefile"]
    sources = [*(ROOT / "dgvit_tpu_torch/ops/csrc").glob("*.cu"),
               ROOT / "dgvit_tpu_torch/replay/csrc/replay.cpp"]
    need = set()
    for src in sources:
        need.add(src)
        for name in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M):
            need.add(src.parent / name)
    for hdr in (ROOT / "dgvit_tpu_torch/ops/csrc").glob("*.cuh"):
        for name in re.findall(r'^#include "([^"]+)"', hdr.read_text(), re.M):
            need.add(hdr.parent / name)
    assert len(need) >= 10
    for path in sorted(need):
        assert path.is_file(), path
        assert shipped(data, path.relative_to(ROOT)), path


def test_build_root(monkeypatch, tmp_path):
    """The build root: $DGVIT_TORCH_BUILD_DIR when set, the checkout's
    build/ when the package sits in one, else the user's cache."""
    from dgvit_tpu_torch.core import build_dir

    monkeypatch.delenv(build_dir.ENV, raising=False)
    assert build_dir.build_root() == ROOT / "build"
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    monkeypatch.setenv(build_dir.ENV, str(tmp_path / "native"))
    assert build_dir.build_root() == tmp_path / "native"
    monkeypatch.delenv(build_dir.ENV)
    monkeypatch.setattr(build_dir, "_CHECKOUT", tmp_path / "site-packages")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build_dir.build_root() == tmp_path / "cache" / "dgvit_tpu_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert build_dir.build_root() == \
        tmp_path / "home" / ".cache" / "dgvit_tpu_torch"


def test_replay_core_builds_under_the_build_root(monkeypatch, tmp_path):
    """The replay buffer compiles its C++ core into its build directory
    (replay/ under the root) and loads it from there."""
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    from dgvit_tpu_torch.replay import buffer

    from dgvit_tpu_torch.core.build_dir import build_root
    assert buffer._BUILD_DIR == build_root() / "replay"
    monkeypatch.setattr(buffer, "_BUILD_DIR", tmp_path / "replay")
    lib = buffer._build_lib()
    assert lib.parent == tmp_path / "replay" and lib.is_file()
