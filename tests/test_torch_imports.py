"""The port stands alone: no module of dgvit_tpu_torch (nor the card
scripts chip_smoke.py, chip_compare.py, chip_draws.py and chip_numerics.py)
imports jax, flax or the JAX package, at import time or in its source."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dgvit_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dgvit_tpu")


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", "")) in (
                              "import_module", "__import__")):
            yield node.args[0].value


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    for m in ("dgvit_tpu_torch.ops.got_megakernel",
              "dgvit_tpu_torch.ops.cls_block",
              "dgvit_tpu_torch.ops.fused_transformer",
              "dgvit_tpu_torch.ops.trunk_train",
              "dgvit_tpu_torch.ops.attention",
              "dgvit_tpu_torch.ops.fused_block",
              "dgvit_tpu_torch.agents.sac",
              "dgvit_tpu_torch.ops.preprocess",
              "dgvit_tpu_torch.ops.fused_preprocess",
              "dgvit_tpu_torch.envs.base",
              "dgvit_tpu_torch.envs.worlds",
              "dgvit_tpu_torch.envs.reward",
              "dgvit_tpu_torch.envs.kinematic",
              "dgvit_tpu_torch.replay.buffer",
              "dgvit_tpu_torch.replay.staging",
              "dgvit_tpu_torch.core.checkpoint",
              "dgvit_tpu_torch.utils.metrics",
              "dgvit_tpu_torch.train.train_rl",
              "dgvit_tpu_torch.train.evaluate",
              "dgvit_tpu_torch.core.rng",
              "dgvit_tpu_torch.envs.vec_kinematic",
              "dgvit_tpu_torch.train.vec_rollout",
              "dgvit_tpu_torch.train.fused_train",
              "dgvit_tpu_torch.replay.device_per",
              "dgvit_tpu_torch.ops.augment",
              "dgvit_tpu_torch.examples.reference_scale_run",
              "dgvit_tpu_torch.envs.fault_aug",
              "dgvit_tpu_torch.envs.faults",
              "dgvit_tpu_torch.tools.robustness_sweep",
              "dgvit_tpu_torch.agents.bc",
              "dgvit_tpu_torch.agents.teacher",
              "dgvit_tpu_torch.train.train_bc",
              "dgvit_tpu_torch.tools.record_teacher_demos",
              "dgvit_tpu_torch.examples.generalization_eval",
              "dgvit_tpu_torch.examples.bc_kinematic_demo",
              "dgvit_tpu_torch.models.cnn",
              "dgvit_tpu_torch.models.simple_vit",
              "dgvit_tpu_torch.models.torch_io"):
        assert m in mods
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(','.join(sorted(bad)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"port loaded {res.stdout.strip()}"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py", ROOT / "chip_compare.py",
                          ROOT / "chip_draws.py", ROOT / "chip_numerics.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_import(path):
    bad = [n for n in _imported_names(path)
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
