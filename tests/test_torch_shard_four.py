"""The port's data-parallel SAC update at four ranks, every flavour, on the
CPU over gloo: the logic half of lead x (the guided updates at world 4).

One job of 4 ranks (tests/torch_dp_worker.py, job `shard`) runs plain,
PER, guided and guided PER from JAX's initial state carried into the
port, with test_torch_shard.py's inputs: a global batch of 16 (4 rows a
rank), 2 updates each, emb-dropout 0, JAX's row noise injected. The
guided inputs have 5 of 16 expert rows valid, so at world 4 rank 0's
expert rows (0-3) are all valid, rank 1's (4-7) lie on both sides of
n_expert (row 4 valid, rows 5-7 not), and ranks 2 and 3 hold none: the
guided step's validity by global row is decided on a rank where it
splits. The engaged agent rows (1 and 4) fall on ranks 0 and 1.

Each flavour is held to two references, with test_torch_shard.py's
tolerances (`METRIC_TOL`, `GRAD_TOL`, `TD_TOL` and its parameter check,
unloosened):
  * JAX's single-device step (`SACAgent(cfg, row_noise=True)`);
  * JAX's own `shardmap_learn` at data=4 on four of the eight virtual CPU
    devices (guided as guided PER with unit weights, which is JAX's
    guided step: `_guided_core`).
The three wrong data axes of test_torch_shard.py fail the same checks at
world 4.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker
from dgvit_tpu.agents.sac import SACAgent as JaxSACAgent
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.core.mesh import MeshRuntime as JaxMeshRuntime
from dgvit_tpu.parallel import shardmap_learn as jax_shardmap_learn
from test_torch_shard import (B, CFG, FLAVORS, N_EXPERT, TD_TOL, UPDATES,
                              inputs, jax_run, mismatches)

WORLD = 4


class ShardmapSteps:
    """JAX's data-axis steps in the single-device agent's call form, for
    `jax_run`."""

    def __init__(self, rt):
        agent = JaxSACAgent(JaxConfig.from_dict(CFG), grad_axis="data")
        self.learn = jax_shardmap_learn(agent, rt, "plain")
        self.learn_per = jax_shardmap_learn(agent, rt, "per")
        self.learn_guidence_per = jax_shardmap_learn(agent, rt, "guided_per")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The 4-rank job beside JAX's single-device and data=4 references."""
    jagent, s0, inp = inputs()
    d = tmp_path_factory.mktemp("dp4")
    torch.save(inp, d / "inputs.pt")
    steps = ShardmapSteps(JaxMeshRuntime.create(
        data=WORLD, devices=jax.devices()[:WORLD]))
    with concurrent.futures.ThreadPoolExecutor(9) as pool:
        job = pool.submit(torch_dp_worker.launch, "shard", WORLD, d)
        runs = {(ref, f): pool.submit(jax_run, agent, s0, inp, f)
                for ref, agent in (("single", jagent), ("shardmap", steps))
                for f in FLAVORS}
        ref = {k: r.result() for k, r in runs.items()}
        ranks = job.result()
    return {"ref": ref, "inp": inp, "ranks": ranks}


def test_guided_inputs_split_a_rank_at_n_expert(four):
    """At world 4 one rank's expert rows lie on both sides of n_expert."""
    per = B // WORLD
    split = [r for r in range(WORLD)
             if r * per < N_EXPERT < (r + 1) * per]
    assert split == [1]
    assert four["inp"]["n_expert"] == N_EXPERT


@pytest.mark.parametrize("flavor", FLAVORS)
def test_four_ranks_match_jax_single_device(four, flavor):
    for rank, out in enumerate(four["ranks"]):
        bad = mismatches(out[flavor], four["ref"][("single", flavor)])
        assert not bad, f"rank {rank} of 4: {bad[:8]}"


@pytest.mark.parametrize("flavor", FLAVORS)
def test_four_ranks_match_jax_shardmap_learn(four, flavor):
    for rank, out in enumerate(four["ranks"]):
        bad = mismatches(out[flavor], four["ref"][("shardmap", flavor)])
        assert not bad, f"rank {rank} of 4: {bad[:8]}"


@pytest.mark.parametrize("flavor", FLAVORS)
def test_four_ranks_hold_one_state(four, flavor):
    """The four ranks end with the same parameters, generator state,
    metrics and td, bit for bit."""
    a = four["ranks"][0][flavor]
    for rank, out in enumerate(four["ranks"][1:], 1):
        b = out[flavor]
        for kind in ("actor", "critic", "critic_target"):
            for n, x in a["state"][kind].items():
                assert torch.equal(x, b["state"][kind][n]), \
                    f"rank {rank}: {kind}.{n}"
        assert torch.equal(a["generator"], b["generator"])
        assert a["metrics"] == b["metrics"]
        for ta, tb in zip(a["td"], b["td"]):
            assert (ta is None and tb is None) or torch.equal(ta, tb)


@pytest.mark.parametrize("flavor", ["per", "guided_per"])
def test_four_ranks_td_is_global_in_row_order(four, flavor):
    ref = four["ref"][("single", flavor)]
    for out in four["ranks"]:
        for u in range(UPDATES):
            assert out[flavor]["td"][u].shape == (B,)
            np.testing.assert_allclose(out[flavor]["td"][u].numpy(),
                                       ref["td"][u], **TD_TOL)


@pytest.mark.parametrize("wrong,flavor", [
    ("summed", "plain"), ("rows_from_zero", "plain"),
    ("expert_contiguous", "guided")])
def test_four_ranks_wrong_data_axes_fail(four, wrong, flavor):
    for rank, out in enumerate(four["ranks"]):
        bad = mismatches(out[f"wrong_{wrong}"],
                         four["ref"][("single", flavor)])
        assert bad, f"rank {rank}: the check passed a wrong data axis " \
                    f"({wrong}) at world 4"
