"""The port's data-parallel SAC update (`parallel/shard.py`,
`SACAgent(grad_axis='data')`) against the JAX package's single-device
step, on the CPU over gloo.

One job of 2 ranks (tests/torch_dp_worker.py) runs every case; one of 4
runs the plain flavour. From JAX's initial state carried into the port
(`models/jax_io`), each flavour (plain, PER, guided with 5 of 16 expert
rows valid, guided PER) takes 2 updates of a global batch of 16 with
emb-dropout 0 and JAX's row noise injected (the global draws, each rank
taking its rows). They are held to `SACAgent(cfg, row_noise=True)`'s
updates, as tests/test_shardmap.py holds JAX's own shard_map step:
  * the metrics of each update: rel 2e-4, abs 2e-5;
  * the gradients each rank's optimisers stepped on (the group's mean)
    against JAX's, read from its Adam first moments (mu = 0.9 mu' + 0.1
    g): rtol 1e-4, atol 1e-5 for the first update (the same parameters
    on both sides); the second's within atol 5e-6 / rtol 1e-4 on 99.5%
    of the elements and its norm within 1e-4 relative;
  * the parameters after the 2 updates: the two-level check (atol 5e-6 /
    rtol 1e-4 on 99.5% of the elements, every element within 2.2 lr);
    log_alpha within 1e-6;
  * PER's |TD errors|: the global batch's, in global row order, on both
    ranks, atol 5e-6 / rtol 1e-4.
The plain flavour is also held to JAX's `shardmap_learn` on 2 of the 8
virtual CPU devices. Three wrong data axes must fail the same checks:
the gradients summed instead of averaged (Adam's step barely moves:
only the gradients tell), every rank taking noise rows 0..b-1, the
guided step's merged rows taken as one contiguous global slice.
"""

import concurrent.futures
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.core.mesh import MeshRuntime as JaxMeshRuntime
from dgvit_tpu.parallel import shardmap_learn as jax_shardmap_learn
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core.checkpoint import state_payload
from dgvit_tpu_torch.models.jax_io import params_from_jax, sac_state_from_jax
from test_torch_sac import guided_noise, step_noise

B, UPDATES, N_EXPERT = 16, 2, 5
CFG = {"model": {"block": 2, "head": 2, "latent_size": 32, "mlp_dim": 64,
                 "image_size": [32, 40], "patch_size": [16, 20],
                 "emb_dropout": 0.0},
       "sac": {"batch_size": B}}
FLAVORS = ("plain", "per", "guided", "guided_per")
METRIC_TOL = dict(rel=2e-4, abs=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TD_TOL = dict(atol=5e-6, rtol=1e-4)


def make_batch(seed, b=B, hw=(32, 40)):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    engage = np.zeros((b, 1), np.float32)
    engage[[i for i in (1, 4) if i < b]] = 1.0     # rank 0's rows only
    return {"obs": f(b, *hw), "pobs": f(b, 2),
            "act": rng.uniform(-1, 1, (b, 2)).astype(np.float32),
            "rew": rng.normal(0, 1, (b, 1)).astype(np.float32),
            "next_obs": f(b, *hw), "next_pobs": f(b, 2),
            "done": np.zeros((b, 1), np.float32), "engage": engage}


def inputs():
    """The carried state and each update's global inputs, and JAX's agent
    and initial state."""
    jagent = JaxSACAgent(JaxConfig.from_dict(CFG), row_noise=True)
    # jitted: the same values as the eager init, in half its time
    s0 = jax.tree_util.tree_map(np.asarray,
                                jax.jit(lambda: jagent.init_state(3))())
    agent = SACAgent(Config.from_dict(CFG), device="cpu", seed=3)
    batches = [make_batch(11 + u) for u in range(UPDATES)]
    experts = []
    for u in range(UPDATES):
        e = make_batch(111 + u)
        e["done"][2] = 1.0
        experts.append(e)
    rng = np.random.default_rng(7)
    weights = [(np.abs(rng.normal(size=B)) + 0.5).astype(np.float32)
               for _ in range(UPDATES)]
    at = [SimpleNamespace(rng=jnp.asarray(s0.rng), itera=jnp.int32(u))
          for u in range(UPDATES)]
    return jagent, s0, {
        "cfg": CFG, "state": state_payload(sac_state_from_jax(agent, s0)),
        "batches": batches, "experts": experts, "weights": weights,
        "n_expert": N_EXPERT,
        "noise": [step_noise(jagent, a, B) for a in at],
        "guided_noise": [guided_noise(jagent, a, 2 * B) for a in at]}


def numpy(tree):
    """A JAX parameter tree as {port name: float32 array}."""
    return {n: np.asarray(t, np.float32) for n, t in params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def jax_run(jagent, s0, inp, flavor, step=None):
    """JAX's 2 updates of `flavor`: metrics, gradients (from the Adam
    first moments), td, and the parameters after."""
    st = jax.tree_util.tree_map(jnp.asarray, s0)
    out = {"metrics": [], "grads": [], "td": []}
    mu0 = {k: 0.0 for k in ("actor", "critic")}
    for u in range(UPDATES):
        b = inp["batches"][u]
        if step is not None:
            res = step(st, b)
        elif flavor == "plain":
            res = jagent.learn(st, b)
        elif flavor == "per":
            res = jagent.learn_per(st, b, inp["weights"][u])
        elif flavor == "guided":
            # JAX's guided step is its guided PER step with unit weights
            # (`_guided_core`); one compile serves both
            res = jagent.learn_guidence_per(st, b, inp["experts"][u],
                                            N_EXPERT, np.ones(B, np.float32))
            res = res[:2]
        else:
            res = jagent.learn_guidence_per(st, b, inp["experts"][u],
                                            N_EXPERT, inp["weights"][u])
        st = res[0]
        out["metrics"].append({k: float(v) for k, v in res[1].items()})
        out["td"].append(np.asarray(res[2]) if len(res) == 3 else None)
        g = {}
        for kind in ("actor", "critic"):
            mu = numpy(getattr(st, f"{kind}_opt")[0].mu)
            g.update({f"{kind}.{n}": (m - 0.9 * mu0[kind][n]
                                      if u else m) / 0.1
                      for n, m in mu.items()})
            mu0[kind] = mu
        out["grads"].append(g)
    out["params"] = {k: numpy(getattr(st, f"{k}_params"))
                     for k in ("actor", "critic", "critic_target")}
    out["log_alpha"] = float(st.log_alpha)
    return out


def mismatches(run, ref, lr=1e-3):
    """Each way the port's run differs from JAX's beyond its tolerance."""
    bad = []
    for u in range(UPDATES):
        for k, r in ref["metrics"][u].items():
            if run["metrics"][u][k] != pytest.approx(r, **METRIC_TOL):
                bad.append(f"update {u} {k}: {run['metrics'][u][k]} vs {r}")
        for n, r in ref["grads"][u].items():
            x = run["grads"][u][n].numpy()
            if u == 0:
                if not np.allclose(x, r, **GRAD_TOL):
                    bad.append(f"update 0 grad {n}")
            else:
                close = np.isclose(x, r, atol=5e-6, rtol=1e-4).mean()
                norm = abs(np.linalg.norm(x) / np.linalg.norm(r) - 1)
                if close < 0.995 or norm > 1e-4:
                    bad.append(f"update 1 grad {n}: {close:.4f} close, "
                               f"norm off {norm:.2e}")
        if ref["td"][u] is not None and not np.allclose(
                run["td"][u].numpy(), ref["td"][u], **TD_TOL):
            bad.append(f"update {u} td")
    for kind, params in ref["params"].items():
        for n, r in params.items():
            x = run["state"][kind][n].numpy()
            close = np.isclose(x, r, atol=5e-6, rtol=1e-4).mean()
            if close < 0.995 or np.abs(x - r).max() > 2.2 * lr:
                bad.append(f"{kind}.{n} after the updates")
    if abs(run["state"]["log_alpha"] - ref["log_alpha"]) > 1e-6:
        bad.append("log_alpha")
    return bad


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """The rank jobs (2 ranks, 4 ranks) beside JAX's references."""
    jagent, s0, inp = inputs()
    d2 = tmp_path_factory.mktemp("dp2")
    d4 = tmp_path_factory.mktemp("dp4")
    for d in (d2, d4):
        torch.save(inp, d / "inputs.pt")
    jmesh = JaxMeshRuntime.create(data=2, devices=jax.devices()[:2])
    jstep = jax_shardmap_learn(JaxSACAgent(JaxConfig.from_dict(CFG),
                                           grad_axis="data"), jmesh)
    # the rank jobs and JAX's five runs side by side (the compiles
    # overlap in part)
    with concurrent.futures.ThreadPoolExecutor(7) as pool:
        jobs = [pool.submit(torch_dp_worker.launch, "shard", w, d)
                for w, d in ((2, d2), (4, d4))]
        runs = {f: pool.submit(jax_run, jagent, s0, inp, f)
                for f in FLAVORS}
        runs["jax_shardmap"] = pool.submit(jax_run, jagent, s0, inp,
                                           "plain", jstep)
        ref = {k: r.result() for k, r in runs.items()}
        ranks2, ranks4 = (j.result() for j in jobs)
    return {"ref": ref, "inp": inp, 2: ranks2, 4: ranks4}


@pytest.mark.parametrize("flavor", FLAVORS)
def test_dp_update_matches_jax_single_device(shard, flavor):
    for rank, out in enumerate(shard[2]):
        bad = mismatches(out[flavor], shard["ref"][flavor])
        assert not bad, f"rank {rank}: {bad[:8]}"


@pytest.mark.parametrize("flavor", FLAVORS)
def test_ranks_hold_one_state(shard, flavor):
    """Every rank ends with the same parameters, bit for bit, the same
    generator state and the same metrics and td."""
    a, b = (r[flavor] for r in shard[2])
    for kind in ("actor", "critic", "critic_target"):
        for n, x in a["state"][kind].items():
            assert torch.equal(x, b["state"][kind][n]), f"{kind}.{n}"
    assert torch.equal(a["generator"], b["generator"])
    assert a["metrics"] == b["metrics"]
    for ta, tb in zip(a["td"], b["td"]):
        assert (ta is None and tb is None) or torch.equal(ta, tb)


@pytest.mark.parametrize("flavor", ["per", "guided_per"])
def test_per_td_is_global_in_row_order(shard, flavor):
    ref = shard["ref"][flavor]
    for out in shard[2]:
        for u in range(UPDATES):
            assert out[flavor]["td"][u].shape == (B,)
            np.testing.assert_allclose(out[flavor]["td"][u].numpy(),
                                       ref["td"][u], **TD_TOL)


def test_four_ranks_plain_matches_jax(shard):
    for rank, out in enumerate(shard[4]):
        bad = mismatches(out["plain"], shard["ref"]["plain"])
        assert not bad, f"rank {rank} of 4: {bad[:8]}"


def test_plain_matches_jax_shardmap_learn(shard):
    """JAX's own data-axis step on 2 virtual CPU devices, the same check."""
    ref = shard["ref"]["jax_shardmap"]
    for out in shard[2]:
        bad = mismatches(out["plain"], ref)
        assert not bad, bad[:8]


@pytest.mark.parametrize("wrong,flavor", [
    ("summed", "plain"), ("rows_from_zero", "plain"),
    ("expert_contiguous", "guided")])
def test_wrong_data_axes_fail(shard, wrong, flavor):
    for out in shard[2]:
        bad = mismatches(out[f"wrong_{wrong}"], shard["ref"][flavor])
        assert bad, f"the check passed a wrong data axis ({wrong})"
    if wrong == "summed":
        # only the gradients tell: Adam's step is scale-free
        assert all(b.startswith("update") and " grad " in b for b in bad)


def test_grad_axis_none_is_the_single_device_update(shard):
    """On a group of one rank the data-axis update (plain, PER, guided,
    the generator's own noise) equals grad_axis None's bit for bit, and
    grad_axis None launches no collective."""
    out = shard[2][0]["world_one"]
    assert out["bit_equal"]
    assert out["none_collectives"] == 0
    assert shard[2][1]["world_one"] is None


def test_live_dropout_masks_differ_noise_is_single_device(shard):
    """emb-dropout 0.1: the masks differ across ranks; the noise each rank
    used is its rows of the single-device stream (the generator's two
    global draws, next-action then policy), and the generator ends the
    same on both ranks."""
    a, b = (r["dropout"] for r in shard[2])
    assert a["finite"] and b["finite"]
    assert len(a["masks"]) == len(b["masks"]) > 0
    assert any(not torch.equal(x, y) for x, y in zip(a["masks"], b["masks"]))
    agent = SACAgent(Config.from_dict(CFG), device="cpu", seed=3)
    g = agent.init_state().generator
    g.set_state(shard["inp"]["state"]["generator"])
    stream = [torch.randn((B, 2), generator=g) for _ in range(2)]
    for rank, out in enumerate((a, b)):
        rows = slice(rank * B // 2, (rank + 1) * B // 2)
        assert len(out["noises"]) == 2
        for used, full in zip(out["noises"], stream):
            assert torch.equal(used, full[rows])
    assert torch.equal(a["generator"], b["generator"])
    assert torch.equal(a["generator"], g.get_state())


def test_nan_guard_rolls_back_on_every_rank(shard):
    """A NaN reward in rank 0's rows: both ranks skip the update (nothing
    moves, the counter advances), and the next clean update runs."""
    for out in (r["nan_guard"] for r in shard[2]):
        assert out["skipped"] == 1.0
        assert not out["moved"] and out["log_alpha_same"]
        assert out["itera"] == 1
        assert out["skipped_clean"] == 0.0
