"""The port's round-5 launcher
(dgvit_tpu_torch/examples/reference_scale_run.py) against the JAX
package's `examples/reference_scale_run.py`, on the CPU.

The JAX launcher trains the flagship config from its first line, so it is
not run here: its flags, its config overrides and its summary's keys are
read from its source (the `add_argument` calls, the unconditional
`cfg.<section>.<field> = <constant>` assignments and the `summary` dict)
and the port's are held equal to them. The port's `main` then runs end to
end on a tiny base config (the recipe's overrides applied to it), on the
fused and on the host path.
"""

import ast
import json
from pathlib import Path

import pytest
import torch

from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.examples import reference_scale_run as rsr

ROOT = Path(__file__).resolve().parent.parent
JAX_LAUNCHER = ROOT / "examples" / "reference_scale_run.py"
HW = (32, 40)


def jax_main():
    tree = ast.parse(JAX_LAUNCHER.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def jax_flags():
    return {c.args[0].value for c in ast.walk(jax_main())
            if isinstance(c, ast.Call) and getattr(c.func, "attr", "")
            == "add_argument"}


def jax_overrides():
    """{('section', 'field'): value} of main's unconditional assignments
    to cfg fields."""
    out = {}
    for node in jax_main().body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Attribute)
                and isinstance(node.targets[0].value, ast.Attribute)
                and getattr(node.targets[0].value.value, "id", "") == "cfg"):
            t = node.targets[0]
            out[t.value.attr, t.attr] = eval(compile(
                ast.Expression(node.value), "<launcher>", "eval"),
                {"__builtins__": {}})
    return out


def jax_summary_keys():
    for node in ast.walk(jax_main()):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "summary"):
            return [k.value for k in node.value.keys]
    raise AssertionError("no summary dict in the JAX launcher")


def test_flags_are_the_jax_launchers_and_device():
    ours = {a.option_strings[0] for a in rsr.parser()._actions
            if a.option_strings[0] != "-h"}
    assert ours == jax_flags() | {"--device"}


def test_recipe_overrides_are_the_jax_launchers():
    over = jax_overrides()
    assert len(over) == 11 and over["sac", "prioritized_replay"] is True
    cfg = rsr.recipe_config(rsr.parser().parse_args([]))
    for (section, name), value in over.items():
        assert getattr(getattr(cfg, section), name) == value, (section, name)


def test_flagship_and_drqc_recipes():
    """The arm_block lines of the flagship (dr_randm32_s11_amin) and of
    drqc_rand8_amin: PER, nan_guard, bf16, SAC batch 32 and a ring of
    min(30000, 8192), the clamps, the seed, the DrQ knobs."""
    common = ["--episodes", "800", "--fused", "--resume", "--eval-world",
              "hospital", "--alpha-max", "2.0", "--alpha-min", "0.1"]
    cfg = rsr.recipe_config(rsr.parser().parse_args(
        common + ["--world", "randm32", "--seed", "11"]))
    s = cfg.sac
    assert (s.prioritized_replay, s.nan_guard, s.batch_size, s.buffer_size,
            s.alpha_min, s.alpha_max, s.aug_shift) == (
        True, True, 32, 30000, 0.1, 2.0, 0)
    assert cfg.model.compute_dtype == "bfloat16" and cfg.train.seed == 11
    assert not cfg.train.pre_train and not cfg.train.pre_buffer
    drqc = rsr.recipe_config(rsr.parser().parse_args(
        common + ["--world", "rand8", "--world-assign", "lane",
                  "--aug-shift", "4", "--aug-critic-only"]))
    assert (drqc.sac.aug_shift, drqc.sac.aug_actor, drqc.sac.aug_warmup,
            drqc.train.seed) == (4, False, 0, 3407)
    warm = rsr.recipe_config(rsr.parser().parse_args(
        ["--aug-shift", "2", "--aug-warmup", "20000"]))
    assert (warm.sac.aug_shift, warm.sac.aug_warmup) == (2, 20000)


def tiny_base():
    return Config.from_dict({
        "model": {"block": 1, "head": 2, "latent_size": 32, "mlp_dim": 64,
                  "image_size": HW, "patch_size": (16, 20)},
        "sac": {"batch_size": 4, "buffer_size": 256},
        "env": {"max_steps": 10}})


def run_main(tmp_path, *flags):
    out = tmp_path / "run"
    summary = rsr.main([*flags, "--out", str(out), "--device", "cpu"],
                       base=tiny_base())
    on_disk = json.loads((out / "summary.json").read_text())
    assert on_disk == json.loads(json.dumps(summary))
    assert list(summary) == jax_summary_keys()
    return summary, out


def test_main_fused_path(tmp_path):
    s, out = run_main(tmp_path, "--fused", "--episodes", "2",
                      "--eval-episodes", "3", "--n-envs", "2", "--chunk",
                      "6", "--world", "randm4", "--eval-world", "rrc",
                      "--seed", "11", "--alpha-min", "0.1", "--alpha-max",
                      "2.0")
    assert s["mode"] == "fused" and s["world"] == "randm4"
    assert s["eval_world"] == "rrc" and s["seed"] == 11
    assert s["train_episodes"] >= 2 and s["eval_episodes"] == 3
    assert s["max_mean_reward"] is None and s["aug"] is None
    assert 0.0 <= s["eval_success_rate"] <= 1.0
    assert list((out / "checkpoints").glob("step_*"))
    rows = [json.loads(ln) for ln in next(out.glob("train_fused_*.jsonl"))
            .read_text().splitlines()]
    assert all(r["alpha"] <= 2.0 for r in rows)


def test_main_fused_drqc_resumes(tmp_path):
    """The drqc recipe (lane-pinned rand8, DrQ shift 4 on the critic only)
    runs, and --resume carries on from its checkpoint and warm ring."""
    flags = ["--fused", "--episodes", "2", "--eval-episodes", "2",
             "--n-envs", "2", "--chunk", "6", "--world", "rand8",
             "--world-assign", "lane", "--aug-shift", "4",
             "--aug-critic-only", "--alpha-min", "0.1"]
    s, out = run_main(tmp_path, *flags)
    assert (s["aug_shift"], s["aug_actor"], s["world_assign"]) == (
        4, False, "lane")
    first = s["train_episodes"]
    s2, _ = run_main(tmp_path, *flags[:2], "4", *flags[3:], "--resume")
    assert s2["train_episodes"] >= max(first, 4)


def test_main_host_path(tmp_path):
    s, out = run_main(tmp_path, "--episodes", "2", "--eval-episodes", "2",
                      "--host-eval")
    assert s["mode"] == "host_loop" and s["eval_episodes"] == 2
    assert isinstance(s["max_mean_reward"], float)
    assert s["train_episodes"] >= 1


def test_aug_refusals(tmp_path):
    """--aug without --fused is a usage error, as in the JAX launcher;
    with --fused the sensor-fault arm runs and its summary names the knobs
    and the gate (the JAX launcher's `"aug": fault_knobs` and
    `"aug_prob": args.aug_prob if fault_knobs else None`)."""
    with pytest.raises(SystemExit):
        rsr.main(["--aug", "obs_noise=0.1", "--device", "cpu", "--out",
                  str(tmp_path)], base=tiny_base())
    s, _ = run_main(tmp_path, "--fused", "--aug", "obs_noise=0.1", "--aug",
                    "patch_occlusion=0.25", "--aug-prob", "0.5",
                    "--episodes", "1", "--eval-episodes", "2", "--n-envs",
                    "2", "--chunk", "4")
    assert s["aug"] == {"obs_noise": 0.1, "patch_occlusion": 0.25}
    assert s["aug_prob"] == 0.5 and s["train_episodes"] >= 1


def test_launcher_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rsr.main(["--fused", "--episodes", "1", "--out", str(tmp_path)],
                 base=tiny_base())
