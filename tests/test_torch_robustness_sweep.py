"""The robustness sweep of the port: `run_eval_vec(sweep=...)`
(dgvit_tpu_torch/train/evaluate.py) and its tool
(dgvit_tpu_torch/tools/robustness_sweep.py), against the JAX package's,
on the CPU at a tiny geometry (32x40 frames, one block).

The sweep's outcomes (successes, collisions, durations of every point of
the tool's 16-point grid) equal JAX's `run_eval_vec(sweep=GRID)` with
JAX's fault draws injected (each step's `fold_in(PRNGKey(seed), t)`,
split, then perturb_obs's split sequence). Mirrors
tests/test_jax_kinematic.py:254: the clean point equals the static run,
a point equals the static run of its knobs, reports carry the knobs. The
static report's keys are JAX's. The tool runs end to end from an actor
npz and from a checkpoint, its grid and row fields are the JAX tool's,
and the repository's tools/robustness_compare.py reads its sweep.jsonl.
"""

import ast
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.models import build_actor as jax_build_actor
from dgvit_tpu.train import evaluate as jax_evaluate
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core.checkpoint import load_params_npz, save_params_npz
from dgvit_tpu_torch.train import evaluate as port_evaluate
from dgvit_tpu_torch.train import fused_train as ft
from dgvit_tpu_torch.tools import robustness_sweep as rs

ROOT = Path(__file__).resolve().parent.parent
JAX_TOOL = ROOT / "tools" / "robustness_sweep.py"
HW = (32, 40)
MODEL = {"block": 1, "head": 2, "latent_size": 32, "mlp_dim": 64,
         "image_size": HW, "patch_size": (16, 20)}
LANES, STEPS = 8, 30
# the actor's initial weights x3: its actions then swing with the frames,
# so that the grid's points end differently (collisions 4, 3, 2, 2 on the
# noise points, 4 clean)
SCALE = 3.0


def cfg_dict(steps=STEPS):
    return {"model": dict(MODEL), "env": {"max_steps": steps},
            "sac": {"batch_size": 4, "buffer_size": 128},
            "train": {"pre_buffer": False, "pre_train": False,
                      "save": False}}


@pytest.fixture(scope="module")
def params():
    actor = jax_build_actor(JaxConfig.from_dict(cfg_dict()))
    return jax.tree_util.tree_map(lambda a: np.asarray(a) * SCALE, actor.init(
        jax.random.PRNGKey(3), np.zeros((1, *HW)), np.zeros((1, 2)))["params"])


def jax_sweep_draws(seed, steps, shape):
    """The fault draws of JAX's sweep at each step (evaluate.py:250-283):
    fold_in(PRNGKey(seed), t), split, then perturb_obs's own splits."""
    rng = jax.random.PRNGKey(seed)
    t = lambda x: torch.from_numpy(np.array(x))
    out = []
    for step in range(steps):
        _, key = jax.random.split(jax.random.fold_in(rng, step))
        key, k = jax.random.split(key)
        n = jax.random.normal(k, shape)
        key, k = jax.random.split(key)
        u = jax.random.uniform(k, shape)
        _, k = jax.random.split(key)
        ky, kx = jax.random.split(k)
        out.append((t(n), t(u), t(jax.random.uniform(ky, (shape[0],))),
                    t(jax.random.uniform(kx, (shape[0],)))))
    return out


@pytest.fixture(scope="module")
def sweeps(params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep")
    cfg, jcfg = Config.from_dict(cfg_dict()), JaxConfig.from_dict(cfg_dict())
    ref = jax_evaluate.run_eval_vec(jcfg, params, LANES, "rrc",
                                    str(tmp / "j"), "m", sweep=rs.GRID)
    draws = jax_sweep_draws(cfg.train.seed, STEPS, (LANES, *HW))
    got = port_evaluate.run_eval_vec(cfg, params, LANES, "rrc",
                                     str(tmp / "p"), "m", sweep=rs.GRID,
                                     device="cpu", draws=draws)
    own = port_evaluate.run_eval_vec(cfg, params, LANES, "rrc",
                                     str(tmp / "o"), "m", sweep=rs.GRID,
                                     device="cpu")
    return {"jax": ref, "port": got, "own": own, "tmp": tmp}


@pytest.mark.parametrize("i", range(len(rs.GRID)))
def test_sweep_outcomes_match_jax(sweeps, i):
    got, ref = sweeps["port"][i], sweeps["jax"][i]
    for k in ("successes", "collisions", "durations", "success_rate",
              "world", "world_seed", *rs.KNOBS):
        assert got[k] == ref[k], (rs.GRID[i], k)


def test_sweep_points_differ_and_draws_decide(sweeps):
    """The grid's points end differently, and the port's own fault draws
    (not JAX's) change some noisy point's outcome: the comparison above
    rests on the draws."""
    outcome = lambda r: (r["successes"], r["collisions"],
                         tuple(r["durations"]))
    assert len({outcome(r) for r in sweeps["port"]}) > 1
    assert outcome(sweeps["own"][0]) == outcome(sweeps["port"][0])
    assert any(outcome(a) != outcome(b)
               for a, b in zip(sweeps["own"], sweeps["port"]))


def test_sweep_tags_match_jax(sweeps):
    tags = lambda d: [ln for ln in (sweeps["tmp"] / d / "testing_data.txt")
                      .read_text().splitlines() if ln.startswith("Model")]
    assert tags("p") == tags("j") and len(tags("p")) == len(rs.GRID)
    assert "Model = m obs_noise=0.19607843137254902 " in "\n".join(tags("p"))


def test_vec_eval_sweep_matches_static(params, tmp_path):
    cfg = Config.from_dict(cfg_dict())
    grid = [{}, {"greying": 0.9}, {"blur": 1.0}, {"patch_occlusion": 0.3},
            {"obs_noise": 0.2, "blur": 0.5, "occlusion": 0.1,
             "patch_occlusion": 0.1, "greying": 0.2}]
    reps = port_evaluate.run_eval_vec(cfg, params, LANES, "rrc",
                                      str(tmp_path / "s"), "m", sweep=grid,
                                      device="cpu")
    assert len(reps) == 5 and reps[1]["greying"] == 0.9
    assert all(0 <= r["successes"] <= LANES for r in reps)
    clean = port_evaluate.run_eval_vec(cfg, params, LANES, "rrc",
                                       str(tmp_path / "c"), "m",
                                       device="cpu")
    for k in ("successes", "collisions", "durations"):
        assert reps[0][k] == clean[k], k
    grey = port_evaluate.run_eval_vec(cfg, params, LANES, "rrc",
                                      str(tmp_path / "g"), "m",
                                      greying=0.9, device="cpu")
    for k in ("successes", "collisions", "durations"):
        assert reps[1][k] == grey[k], k
    # a point with draws equals the static run of its knobs: both restart
    # the fault draws from the config's seed
    noisy = port_evaluate.run_eval_vec(
        cfg, params, LANES, "rrc", str(tmp_path / "n"), "m",
        sweep=[{"obs_noise": 0.2, "occlusion": 0.3}], device="cpu")[0]
    static = port_evaluate.run_eval_vec(
        cfg, params, LANES, "rrc", str(tmp_path / "n2"), "m",
        obs_noise=0.2, occlusion=0.3, device="cpu")
    for k in ("successes", "collisions", "durations"):
        assert noisy[k] == static[k], k


def test_static_report_keys_match_jax(params, tmp_path):
    cfg, jcfg = Config.from_dict(cfg_dict(8)), JaxConfig.from_dict(
        cfg_dict(8))
    kw = dict(obs_noise=0.1, greying=0.2)
    ref = jax_evaluate.run_eval_vec(jcfg, params, 4, "rrc",
                                    str(tmp_path / "j"), "m", **kw)
    got = port_evaluate.run_eval_vec(cfg, params, 4, "rrc",
                                     str(tmp_path / "p"), "m",
                                     device="cpu", **kw)
    assert set(got) == set(ref)
    for k in (*rs.KNOBS, "world", "world_seed"):
        assert got[k] == ref[k] and type(got[k]) is type(ref[k]), k


# --------------------------------------------------------------------------
# the tool
# --------------------------------------------------------------------------

def jax_tool():
    return ast.parse(JAX_TOOL.read_text())


def test_grid_and_knobs_are_the_jax_tools():
    scope = {}
    for node in jax_tool().body:
        if isinstance(node, ast.Assign) and node.targets[0].id in ("GRID",
                                                                   "KNOBS"):
            scope[node.targets[0].id] = eval(compile(
                ast.Expression(node.value), "<tool>", "eval"))
    assert scope["GRID"] == rs.GRID and len(rs.GRID) == 16
    assert scope["KNOBS"] == rs.KNOBS


def jax_row_keys():
    for node in ast.walk(jax_tool()):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "row"):
            keys = []
            for k, v in zip(node.value.keys, node.value.values):
                keys += list(rs.KNOBS) if k is None else [k.value]
            return keys
    raise AssertionError("no row dict in the JAX tool")


def robustness_compare():
    spec = importlib.util.spec_from_file_location(
        "robustness_compare", ROOT / "tools" / "robustness_compare.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool_run(params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tool")
    cfg_yaml = tmp / "cfg.yaml"
    cfg_yaml.write_text(yaml.safe_dump(Config.from_dict(cfg_dict(8))
                                       .to_dict()))
    actor = save_params_npz(str(tmp), "tiny", params)
    out = tmp / "out"
    rows = rs.main(["--actor", actor, "--worlds", "rrc", "hospital",
                    "--episodes", "3", "--config", str(cfg_yaml),
                    "--device", "cpu", "--out", str(out)])
    return {"rows": rows, "out": out, "tmp": tmp, "cfg": cfg_yaml}


def test_tool_writes_the_jax_tools_rows(tool_run):
    rows = tool_run["rows"]
    assert len(rows) == 2 * len(rs.GRID)
    on_disk = [json.loads(ln) for ln in (tool_run["out"] / "sweep.jsonl")
               .read_text().splitlines()]
    assert on_disk == rows
    assert all(list(r) == jax_row_keys() for r in rows)
    assert {r["actor"] for r in rows} == {"tiny_actor"}
    assert [r["world"] for r in rows] == ["rrc"] * 16 + ["hospital"] * 16
    md = (tool_run["out"] / "sweep.md").read_text()
    assert md.count("| clean |") == 2 and "## hospital" in md
    assert "| obs_noise=0.196 |" in md


def test_robustness_compare_reads_the_port_sweep(tool_run, capsys):
    rc = robustness_compare()
    path = tool_run["out"] / "sweep.jsonl"
    points, cols = rc.load_sweeps([("port", str(path))], "rrc")
    assert len(points) == len(rs.GRID) and points[0] == ()
    table = rc.render_markdown(points, cols)
    assert table.splitlines()[0] == "| fault | port, rrc |"
    assert len(table.splitlines()) == 2 + len(rs.GRID)
    rc.main([f"port={path}"])
    assert "port, hospital" in capsys.readouterr().out


def test_tool_from_a_checkpoint_and_export(tool_run):
    tmp = tool_run["tmp"]
    cfg = Config.from_dict(cfg_dict(8))
    cfg.train.save = True
    ft.train_fused(cfg, out_dir=str(tmp / "train"), n_envs=2, chunk=4,
                   rounds=1, rounds_per_dispatch=1, updates_per_round=1,
                   ring_capacity=32, device="cpu")
    rows = rs.main(["--checkpoint", str(tmp / "train" / "checkpoints"),
                    "--worlds", "rrc", "--episodes", "2", "--config",
                    str(tool_run["cfg"]), "--device", "cpu", "--out",
                    str(tmp / "ck"), "--export-actor",
                    str(tmp / "exp" / "ck_actor.npz")])
    assert len(rows) == len(rs.GRID) and rows[0]["actor"] == "step_1"
    exported = load_params_npz(str(tmp / "exp" / "ck_actor.npz"))
    params, _ = port_evaluate.checkpoint_actor(
        cfg, str(tmp / "train" / "checkpoints"))
    assert set(exported) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(exported[k], v)
    with pytest.raises(SystemExit):
        rs.main(["--worlds", "rrc"])


def test_tool_without_a_card_raises(tool_run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rs.main(["--actor", str(tool_run["tmp"] / "tiny_actor.npz"),
                 "--worlds", "rrc", "--episodes", "2", "--config",
                 str(tool_run["cfg"]), "--out", str(tool_run["tmp"] / "x")])
