"""The port's mesh layer (`core/mesh.py`, `core/distributed.py`) and the
mesh section of its config, on the CPU.

One job of 2 gloo ranks (tests/torch_dp_worker.py) runs the cases that
need a process group: `initialize` joins it from torchrun's variables,
`MeshRuntime` takes data = the world size (and -1) and refuses a
mismatch, model > 1 and seq > 1 by name; `shard_batch` and
`local_batch_slice` are rank-major; `replicate`, `broadcast_object` and
`shard_sac_state` make rank 0's values every rank's (the generators' and
the optimisers' states too); the active-mesh registry; `sharded_learn`
of a grad_axis None agent is shardmap_learn of its data-axis twin; the
barrier holds the early rank. The rest runs in this process.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_dp_worker
from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core import distributed
from dgvit_tpu_torch.core.mesh import (AXIS_DATA, AXIS_MODEL, AXIS_SEQ, Mesh,
                                       MeshRuntime, active_mesh, make_mesh,
                                       use_mesh)
from dgvit_tpu_torch.parallel import shard, sharded_learn
from test_torch_shard import CFG, make_batch

WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    torch.save({"cfg": CFG, "batches": [make_batch(21), make_batch(22)],
                "noise": [None, (np.random.default_rng(0).normal(
                    size=(16, 2)).astype(np.float32),) * 2]},
               d / "inputs.pt")
    return torch_dp_worker.launch("mesh", WORLD, d)


def test_initialize_joins_the_group_over_gloo(ranks):
    for r, out in enumerate(ranks):
        assert out["backend"] == "gloo"
        assert (out["rank"], out["world"]) == (r, WORLD)
        assert out["initialize_again"] is True


def test_mesh_takes_the_world_size(ranks):
    for r, out in enumerate(ranks):
        world, rank, absorbed, shape = out["mesh"]
        assert (world, rank, absorbed) == (WORLD, r, WORLD)
        assert shape == {AXIS_DATA: WORLD, AXIS_MODEL: 1, AXIS_SEQ: 1}


@pytest.mark.parametrize("kw,kind,name", [
    ({"data": WORLD + 1}, "ValueError", "'data'"),
    ({"data": 1}, "ValueError", "'data'"),
    ({"model": 2}, "NotImplementedError", "'model'"),
    ({"seq": 2}, "NotImplementedError", "'seq'")])
def test_mesh_refuses_by_name(ranks, kw, kind, name):
    for out in ranks:
        err = out["refused"][str(kw)]
        assert err is not None and err[0] == kind and name in err[1]


def test_shard_batch_and_local_slice_are_rank_major(ranks):
    for r, out in enumerate(ranks):
        rows = slice(4 * r, 4 * r + 4)
        assert torch.equal(out["shard"]["x"],
                           torch.arange(24).reshape(8, 3)[rows])
        np.testing.assert_array_equal(out["shard"]["n"], np.arange(8)[rows])
        assert out["shard"]["k"] == 5
        assert out["slice"] == rows


def test_replicate_broadcasts_rank_0(ranks):
    for out in ranks:
        t, w = out["replicated"]
        assert torch.equal(t, torch.ones(3))
        assert torch.equal(w, torch.zeros(2, 3))
        assert out["object"] == {"from": 0}


def test_active_mesh_registry(ranks):
    for out in ranks:
        assert out["active"] and out["inactive"]


def test_shard_sac_state_is_rank_0s(ranks):
    """Rank 0 after one update, rank 1 fresh from another seed: both end
    with rank 0's parameters, log_alpha, counter, generator and Adam
    state."""
    a, b = (out["state"] for out in ranks)
    assert a["itera"] == b["itera"] == 1
    assert torch.equal(a["generator"], b["generator"])
    assert torch.equal(a["log_alpha"], b["log_alpha"])
    for k, v in a["actor"].items():
        assert torch.equal(v, b["actor"][k]), k
    assert ranks[0]["opt_steps"] == ranks[1]["opt_steps"]
    assert set(ranks[1]["opt_steps"]) == {1.0}


def test_sharded_learn_is_the_data_axis_step(ranks):
    """A grad_axis None agent under sharded_learn takes the same update
    as a grad_axis='data' agent under shardmap_learn, bit for bit."""
    for out in ranks:
        (sa, ma), (sb, mb) = out["sharded_learn"]
        assert ma == mb
        for kind in ("actor", "critic", "critic_target"):
            for n, x in sa[kind].items():
                assert torch.equal(x, sb[kind][n]), f"{kind}.{n}"


def test_barrier_holds_the_early_rank(ranks):
    early_out = ranks[0]["barrier"][1]
    late_in = ranks[1]["barrier"][0] + 0.5
    assert early_out >= late_in - 0.05


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.local_batch_slice(8) == slice(0, 8)


def test_initialize_needs_a_rank(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("PROCESS_ID", raising=False)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="rank"):
        distributed.initialize()


def test_backend_rule(monkeypatch):
    """gloo without a card, NCCL with a card a rank; ranks that share a
    card must name gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert distributed.default_backend(4) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.default_backend(2) == "nccl"
    with pytest.raises(ValueError, match="gloo"):
        distributed.default_backend(4)


def test_one_process_mesh():
    rt = MeshRuntime.create(device="cpu")
    assert (rt.world, rt.rank, rt.group) == (1, 0, None)
    assert rt.shard_batch({"x": np.arange(6)})["x"].tolist() == list(range(6))
    assert make_mesh(data=1, device="cpu").data == 1
    with pytest.raises(ValueError, match="'data'"):
        make_mesh(data=2, device="cpu")
    with use_mesh(rt):
        assert active_mesh() is rt.mesh
    assert active_mesh() is None


@pytest.mark.parametrize("over", [{"mesh": {"data": 2}}, {"mesh": {"data": 8}},
                                  {"mesh": {"data": -1}}])
def test_mesh_config_takes_data_above_one(over):
    """MeshConfig takes any data, as JAX's does (the world size is held
    when the mesh is built)."""
    assert Config.from_dict(over).mesh.data == JaxConfig.from_dict(
        over).mesh.data == over["mesh"]["data"]


@pytest.mark.parametrize("over,name", [({"mesh": {"model": 2}}, "model"),
                                       ({"mesh": {"seq": 2}}, "seq"),
                                       ({"mesh": {"data": 2, "model": 4}},
                                        "model")])
def test_mesh_config_refuses_model_and_seq(over, name):
    JaxConfig.from_dict(over)
    with pytest.raises(NotImplementedError, match=name):
        Config.from_dict(over)


def test_unported_parallel_entry_points_raise_by_name():
    """The model axis still raises by name; the sharded collection and
    round (ported) refuse an agent without the data axis."""
    rt = MeshRuntime(Mesh(data=2, model=1, seq=1, rank=0, group=None,
                          device=torch.device("cpu")))
    agent = SimpleNamespace(grad_axis=None)
    for fn, args in ((shard.shardmap_collect, (None, 4, 4, 0.25, 1.0)),
                     (shard.shardmap_fused_round,
                      (None, 4, 6, 1, 8, 64, 0.25, 1.0))):
        with pytest.raises(ValueError, match="grad_axis='data'"):
            fn(agent, rt, *args)
    model_mesh = MeshRuntime(Mesh(data=1, model=2, seq=1, rank=0, group=None,
                                  device=torch.device("cpu")))
    with pytest.raises(NotImplementedError, match="'model'"):
        sharded_learn(None, model_mesh)
