"""The port's serving slice as a whole, against the JAX package, on the CPU:
the GoT actor at a small size, the trained full-width actor through
`make_action_fn`, and the golden actions file the chip smoke test reads.

Regenerate the golden file with `python tests/test_torch_policy.py`.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.models import build_actor as jax_build_actor
from dgvit_tpu.models.got import GoT as JaxGoT
from dgvit_tpu.serve import make_action_fn as jax_make_action_fn
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core.checkpoint import load_params_npz
from dgvit_tpu_torch.models import build_actor, params_from_jax
from dgvit_tpu_torch.serve import make_action_fn

ROOT = Path(__file__).resolve().parent.parent
ACTOR = ROOT / "artifacts" / "r5" / "dr_randm32_s11_amin_actor.npz"
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
GOLDEN_SEED, GOLDEN_FRAMES = 2026, 16

SMALL = dict(latent_size=64, dim_head=16, mlp_dim=128, block=3, head=2,
             image_size=[32, 40])


def unflatten(flat):
    tree = {}
    for key, val in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def golden_inputs(seed=GOLDEN_SEED, frames=GOLDEN_FRAMES):
    """The golden frames: depth in [0, 1], polar goals (distance, heading).
    chip_smoke.py draws the same arrays from the same seed."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0, 1, (frames, 128, 160)).astype(np.float32)
    goal = np.stack([rng.uniform(0, 1, frames), rng.uniform(-1, 1, frames)],
                    axis=1).astype(np.float32)
    return obs, goal


def jax_golden(flat):
    """JAX fp32 actions (the export map, composed path) and trunk latents."""
    params = unflatten(flat)
    obs, goal = golden_inputs()
    actions = np.asarray(jax_make_action_fn(JaxConfig(), params)(obs, goal))
    emb = params["fc_embed"]
    goal_tok = jnp.dot(goal, emb["kernel"]) + emb["bias"]
    latents = np.asarray(JaxGoT().apply({"params": params["trans"]}, obs,
                                        goal_tok))
    return actions, latents


@pytest.fixture(scope="module")
def trained():
    return load_params_npz(str(ACTOR))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_policy_matches_jax_small(dtype):
    """GoTPolicy (mean, log_std) against the JAX GoTPolicy at a small size.
    fp32 runs the JAX composed path; bf16 runs the JAX megakernel in
    interpret mode, whose rounding the port reproduces."""
    jcfg = JaxConfig.from_dict({"model": SMALL})
    jdt = getattr(jnp, dtype)
    actor = jax_build_actor(jcfg, dtype=None if dtype == "float32" else jdt)
    rng = np.random.default_rng(11)
    obs = rng.uniform(0, 1, (3, 32, 40)).astype(np.float32)
    goal = rng.normal(0, 0.5, (3, 2)).astype(np.float32)
    params = actor.init(jax.random.PRNGKey(0), obs, goal)
    if dtype == "bfloat16":
        os.environ["DGVIT_MEGA_INTERPRET"] = "1"
    try:
        ref = actor.apply(params, obs, goal, inference=True)
    finally:
        os.environ.pop("DGVIT_MEGA_INTERPRET", None)

    pol = build_actor(Config.from_dict({"model": SMALL}),
                      dtype=getattr(torch, dtype))
    pol.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        out = pol(torch.from_numpy(obs), torch.from_numpy(goal),
                  inference=True)
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def test_full_width_trained_actor_fp32(trained):
    """The trained flagship actor, loaded from its npz, through the port's
    make_action_fn (fp32, CPU) against the JAX export map: ~1e-5."""
    obs, goal = golden_inputs(seed=5, frames=4)
    act = make_action_fn(Config(), trained, dtype=torch.float32,
                         device="cpu")
    ref = np.asarray(jax_make_action_fn(JaxConfig(), unflatten(trained))(
        obs, goal))
    out = act(obs, goal)
    assert out.dtype == np.float32 and out.shape == (4, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_env_units_match_jax(trained):
    obs, goal = golden_inputs(seed=6, frames=2)
    cfg, jcfg = Config(), JaxConfig()
    act = make_action_fn(cfg, trained, env_units=True, dtype=torch.float32,
                         device="cpu")
    ref = jax_make_action_fn(jcfg, unflatten(trained), env_units=True)
    np.testing.assert_allclose(act(obs, goal), np.asarray(ref(obs, goal)),
                               rtol=1e-5, atol=1e-5)


def test_golden_file_is_current(trained):
    """Re-derive the golden actions and latents from JAX, and hold the
    port's fp32 CPU path to them."""
    g = np.load(GOLDEN)
    actions, latents = jax_golden(trained)
    assert int(g["seed"]) == GOLDEN_SEED
    np.testing.assert_allclose(g["actions"], actions, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g["latents"], latents, rtol=1e-5, atol=1e-5)
    obs, goal = golden_inputs()
    act = make_action_fn(Config(), trained, dtype=torch.float32,
                         device="cpu")
    np.testing.assert_allclose(act(obs, goal), g["actions"], rtol=1e-5,
                               atol=1e-5)
    pol = act.policy
    with torch.no_grad():
        lat = pol.trans(torch.from_numpy(obs),
                        pol.fc_embed(torch.from_numpy(goal)), inference=True)
    np.testing.assert_allclose(lat.numpy(), g["latents"], rtol=1e-4,
                               atol=1e-4)


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(ROOT / "tests"))
    import conftest  # noqa: F401  (pins JAX to the CPU)

    acts, lats = jax_golden(load_params_npz(str(ACTOR)))
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez(GOLDEN, seed=GOLDEN_SEED, actions=acts, latents=lats)
    print(f"wrote {GOLDEN}: actions {acts.shape}, latents {lats.shape}")
