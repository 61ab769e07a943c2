"""The port's generalization launcher
(dgvit_tpu_torch/examples/generalization_eval.py) and BC demo
(dgvit_tpu_torch/examples/bc_kinematic_demo.py) against the JAX
package's `examples/`, on the CPU at a tiny base config (one block,
32x40 frames).

The JAX launcher trains from its first line, so its flags and its
summary line's keys are read from its source (the `add_argument` calls,
the dict printed last) and the port's are held equal to them. The port's
`main` runs end to end with --device cpu on the --skip-rl path (demos,
BC fit, evaluations) and on the --fused --expert-buffer --bc-params
path (the warm start copied byte for byte, the guided fused fine-tune
from it), and its `final_actor.npz` loads through JAX's loader with
JAX's template. Without a card and without --device cpu it raises.
"""

import ast
import glob
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.core import checkpoint as jax_ckpt
from dgvit_tpu.models.policies import GoTPolicy as JaxGoTPolicy
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core.checkpoint import load_params_npz
from dgvit_tpu_torch.examples import bc_kinematic_demo as bkd
from dgvit_tpu_torch.examples import generalization_eval as ge

ROOT = Path(__file__).resolve().parent.parent
JAX_LAUNCHER = ROOT / "examples" / "generalization_eval.py"
HW = (32, 40)
DIMS = ["--dim", "32", "--dim-head", "16"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are tiny, and beside the other
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_main():
    tree = ast.parse(JAX_LAUNCHER.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def jax_flags():
    return {c.args[0].value for c in ast.walk(jax_main())
            if isinstance(c, ast.Call) and getattr(c.func, "attr", "")
            == "add_argument"}


def jax_summary_keys():
    """The keys of the dict main prints last (json.dumps({...}))."""
    dumps = [c for c in ast.walk(jax_main()) if isinstance(c, ast.Call)
             and getattr(c.func, "attr", "") == "dumps"]
    return [k.value for k in dumps[-1].args[0].keys]


def tiny_base():
    return Config.from_dict({
        "model": {"block": 1, "head": 2, "latent_size": 32, "mlp_dim": 64,
                  "image_size": HW, "patch_size": (16, 20)},
        "sac": {"batch_size": 4, "buffer_size": 256}})


def jax_template():
    """JAX's BC policy of the launcher at the tiny widths."""
    return JaxGoTPolicy(block=1, head=2, l_f_size=32, dim_head=16,
                        mlp_dim=64, image_size=HW, final_norm="rms",
                        emb_dropout=0.0).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW)), jnp.zeros((1, 2)))[
            "params"]


def loads_in_jax(path):
    loaded = jax_ckpt.load_params_npz(str(path), jax_template())
    flat = load_params_npz(str(path))
    leaves = jax.tree_util.tree_leaves_with_path(loaded)
    assert len(leaves) == len(flat)
    return loaded


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def bc_run(tmp_path_factory):
    """The --skip-rl path: 2 scripted-pilot episodes, a 2-epoch BC fit,
    2 evaluation episodes a world."""
    out = tmp_path_factory.mktemp("gen") / "bc"
    summary = ge.main(["--bc-episodes", "2", "--bc-epochs", "2",
                       "--skip-rl", "--vec-eval", "--eval-episodes", "2",
                       *DIMS, "--out", str(out), "--device", "cpu"],
                      base=tiny_base())
    return out, summary


def test_flags_are_the_jax_launchers_and_device():
    ours = {a.option_strings[0] for a in ge.parser()._actions
            if a.option_strings[0] != "-h"}
    assert ours == jax_flags() - {"--platform"} | {"--device"}


def test_skip_rl_path(bc_run, capsys):
    out, s = bc_run
    assert list(s) == jax_summary_keys()
    assert s["recipe"] == "bc-only" and s["sac_goals"] == 0
    assert np.isfinite(s["bc_val_rmse"]) and s["bc_val_rmse"] > 0
    assert 0.0 <= s["rrc"] <= 1.0 and 0.0 <= s["hospital"] <= 1.0
    demos = sorted((out / "demos" / "RRC" / "torch").glob("*.npz"))
    assert [p.name for p in demos] == ["demo_RRC_0.npz", "demo_RRC_1.npz"]
    assert (out / "il" / "bc_warm_actor.npz").exists()
    # the evaluated actor is the BC warm start
    final = loads_in_jax(out / "final_actor.npz")
    warm = load_params_npz(str(out / "il" / "bc_warm_actor.npz"))
    for path, leaf in jax.tree_util.tree_leaves_with_path(final):
        key = "/".join(p.key for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), warm[key])
    assert (out / "eval" / "testing_data.txt").exists()


def test_fused_expert_path_from_the_warm_start(bc_run, tmp_path, capsys):
    bc_out, _ = bc_run
    out = tmp_path / "rl"
    s = ge.main(["--fused", "--vec-eval", "--expert-buffer", "--demos",
                 str(bc_out / "demos"), "--bc-params",
                 str(bc_out / "il" / "bc_warm"), "--rl-episodes", "1",
                 "--n-envs", "4", "--chunk", "2", "--eval-episodes", "2",
                 "--alpha-init", "0.05", "--guidence-weight", "10", *DIMS,
                 "--out", str(out), "--device", "cpu"], base=tiny_base())
    printed = capsys.readouterr().out
    assert last_json(printed) == json.loads(json.dumps(s))
    assert list(s) == jax_summary_keys()
    assert s["recipe"] == "alpha0=0.05 expert=True gw=10.0 d=32"
    assert s["bc_val_rmse"] is None and s["sac_goals"] >= 0
    assert (out / "il" / "bc_warm_actor.npz").read_bytes() == (
        bc_out / "il" / "bc_warm_actor.npz").read_bytes()
    assert "expert corpus on the device" in printed
    rows = [json.loads(ln) for ln in next((out / "rl").glob(
        "train_fused_*.jsonl")).read_text().splitlines()]
    assert rows and all(np.isfinite(r["qf1_loss"]) for r in rows)
    assert rows[-1]["episodes"] >= 1
    loads_in_jax(out / "final_actor.npz")


def test_skip_rl_refuses_bc_params(tmp_path):
    with pytest.raises(SystemExit):
        ge.main(["--skip-rl", "--bc-params", "x", "--device", "cpu"],
                base=tiny_base())


def test_without_a_card_it_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ge.main(["--skip-rl", "--out", str(tmp_path)], base=tiny_base())
    assert not list(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bkd.main(["--out", str(tmp_path)], base=tiny_base())


@pytest.mark.parametrize("layout", ["RRC/jax", "RRC/torch", "rand8/teacher"])
def test_demo_glob_reads_every_layout(tmp_path, layout):
    d = tmp_path / layout
    d.mkdir(parents=True)
    (d / "demo_0.npz").write_bytes(b"")
    assert glob.glob(ge.demo_glob(tmp_path)) == [str(d / "demo_0.npz")]


def test_jax_recorded_corpus_wins_over_the_ports(tmp_path):
    for layout in ("RRC/torch", "RRC/jax"):
        (tmp_path / layout).mkdir(parents=True)
    assert ge.demo_glob(tmp_path) == str(tmp_path / "RRC" / "jax" / "*.npz")


def test_bc_kinematic_demo(tmp_path, capsys):
    base = tiny_base()
    base.env.max_steps = 20
    res = bkd.main(["--episodes", "2", "--epochs", "2", "--eval-episodes",
                    "2", "--out", str(tmp_path), "--device", "cpu"],
                   base=base)
    printed = capsys.readouterr().out
    assert "recorded 2 episodes" in printed
    assert "cloned policy success" in printed
    assert 0.0 <= res["success_rate"] <= 1.0
    assert (tmp_path / "Data" / "RRC" / "torch").is_dir()
