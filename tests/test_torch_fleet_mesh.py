"""The fleet trainer's learner over the data axis
(`train_fleet(mesh_data=2)`, `--mesh-data 2`), on two gloo ranks of the
CPU; mirrors tests/test_train_fleet.py's mesh cases (:124 plain, :138
guided PER).

One job of 2 ranks (tests/torch_dp_worker.py, job `fleet`): rank 0 runs
two robots for two episodes, the server and the replay buffer, and sends
each update's global arrays; rank 1 follows. Plain, then guided PER with
demos the port records. Held:
  * errors == {}, updates > 0 and itera == updates on rank 0, and the
    follower ran as many updates;
  * both ranks end with one state, bit for bit;
  * checkpoints and the final actor are written by rank 0 only;
  * the campaign's first update equals shardmap_learn's on the arrays
    rank 0 sent, from the state before it, on both ranks, bit for bit;
  * mesh_data other than the world size raises by name.
"""

import pytest
import torch

import torch_dp_worker
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.train import demo_record
from test_torch_train_fleet import fleet_cfg

FLAVOURS = ["plain", "guided_per"]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    env = KinematicNavEnv(default_records(seed=0), image_hw=(32, 40))
    assert demo_record.record_episodes(
        env, demo_record.scripted_pilot, str(d / "demos"), episodes=2,
        max_steps=20)
    torch.save({"cfg": fleet_cfg().to_dict(),
                "expert_glob": str(d / "demos" / "RRC" / "torch" / "*.npz")},
               d / "inputs.pt")
    return torch_dp_worker.launch("fleet", 2, d, 300.0)


def same(a, b):
    return all(torch.equal(x, b[kind][n]) for kind in
               ("actor", "critic", "critic_target")
               for n, x in a[kind].items()) and \
        a["log_alpha"] == b["log_alpha"] and a["itera"] == b["itera"]


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_fleet_mesh_collects_and_learns(fleet, flavour):
    lead, follower = (r[flavour] for r in fleet)
    assert lead["errors"] == {}
    assert lead["updates"] > 0
    assert int(lead["itera"]) == lead["updates"]
    assert follower["updates"] == lead["updates"]
    assert lead["flavor"] == follower["flavor"] == flavour


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_fleet_mesh_ranks_hold_one_state(fleet, flavour):
    lead, follower = (r[flavour] for r in fleet)
    assert same(lead["state"], follower["state"])


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_fleet_mesh_rank0_alone_writes(fleet, flavour):
    lead, follower = (r[flavour] for r in fleet)
    assert any(f.startswith("checkpoints/step_") for f in lead["files"])
    assert any(f.startswith("models/fleet_") and f.endswith("_actor.npz")
               for f in lead["files"])
    assert not any(f.startswith(("checkpoints", "models"))
                   for f in follower["files"])


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_fleet_mesh_first_update_is_shardmap_learns(fleet, flavour):
    for rank, r in enumerate(fleet):
        out = r[flavour]
        assert same(out["first_replayed"], out["first"]), f"rank {rank}"


def test_fleet_mesh_data_must_equal_world(fleet):
    for r in fleet:
        assert r["refused"] is not None
        assert "--mesh-data 4" in r["refused"] and "2 rank" in r["refused"]
