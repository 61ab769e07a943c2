"""The kernel build (dgvit_tpu_torch/ops/_build.py) from several threads.

A fake `nvcc` on the PATH stands in for the CUDA toolkit: it logs each
call, waits a little (so a second thread arrives while the first
compiles) and links an empty shared library with the host C++ compiler.
Two threads that load one source at once must compile it once and both
get the library; an edited source builds again."""

import os
import shutil
import stat
import sys
import threading
import time

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
