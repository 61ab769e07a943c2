"""The port's serving layer on the CPU: BatchingActorServer semantics
(coalescing, bucket padding, oversize split, error surfacing, cancelled
futures, close stragglers) in front of the port's make_action_fn, and the
device rule of the entry points (CUDA unless the CPU is asked for; no
quiet fall back)."""

import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.config import Config as JaxConfig
from dgvit_tpu.models import build_actor as jax_build_actor
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core.device import resolve_device
from dgvit_tpu_torch.ops.got_megakernel import got_forward_fused
from dgvit_tpu_torch.serve import BatchingActorServer, make_action_fn

SMALL = dict(latent_size=16, dim_head=16, mlp_dim=32, block=2, head=2,
             image_size=[32, 40])


@pytest.fixture(scope="module")
def small_cfg():
    return Config.from_dict({"model": SMALL})


@pytest.fixture(scope="module")
def actor_params():
    actor = jax_build_actor(JaxConfig.from_dict({"model": SMALL}))
    v = actor.init(jax.random.PRNGKey(0), np.zeros((1, 32, 40)),
                   np.zeros((1, 2)))
    return jax.tree_util.tree_map(np.asarray, v["params"])


@pytest.fixture(scope="module")
def act(small_cfg, actor_params):
    return make_action_fn(small_cfg, actor_params, dtype=torch.float32,
                          device="cpu")


def test_batching_server_correctness_and_coalescing(act):
    calls = []

    def counting_act(obs, goal):
        calls.append(obs.shape[0])
        return act(obs, goal)

    rng = np.random.default_rng(7)
    reqs = [(rng.uniform(0, 1, (32, 40)).astype(np.float32),
             rng.normal(0, 0.3, 2).astype(np.float32)) for _ in range(16)]
    with BatchingActorServer(counting_act, max_wait_ms=50.0,
                             buckets=(1, 2, 4, 8, 16)) as srv:
        srv.act(reqs[0][0], reqs[0][1])
        barrier = threading.Barrier(16)
        futs = [None] * 16

        def client(i):
            barrier.wait()
            futs[i] = srv.submit(*reqs[i])

        ts = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        outs = [f.result(timeout=30) for f in futs]
        st = srv.stats()

    for (obs, goal), out in zip(reqs, outs):
        ref = act(obs[None], goal[None])[0]
        np.testing.assert_allclose(out, ref, atol=1e-6)
        assert out.shape == (2,)
    assert st["requests"] == 17
    assert st["dispatches"] < 17, f"no batching happened: {calls}"


def test_batching_server_padding_and_oversize(act):
    shapes = []

    def record_act(obs, goal):
        shapes.append(obs.shape[0])
        return act(obs, goal)

    rng = np.random.default_rng(3)
    obs = rng.uniform(0, 1, (11, 32, 40)).astype(np.float32)
    goal = rng.normal(0, 0.3, (11, 2)).astype(np.float32)
    with BatchingActorServer(record_act, max_wait_ms=1.0,
                             buckets=(1, 2, 4)) as srv:
        out = srv.act(obs, goal)
    np.testing.assert_allclose(out, act(obs, goal), atol=1e-6)
    assert shapes == [4, 4, 4]


def test_server_surfaces_worker_errors():
    def broken(obs, goal):
        raise RuntimeError("device fell over")

    with BatchingActorServer(broken, max_wait_ms=1.0) as srv:
        fut = srv.submit(np.zeros((32, 40), np.float32),
                         np.zeros(2, np.float32))
        with pytest.raises(RuntimeError, match="device fell over"):
            fut.result(timeout=10)


def test_server_survives_cancelled_future(act):
    gate = threading.Event()

    def slow_act(obs, goal):
        gate.wait(10)
        return act(obs, goal)

    obs = np.zeros((32, 40), np.float32)
    goal = np.zeros(2, np.float32)
    with BatchingActorServer(slow_act, max_wait_ms=1.0) as srv:
        fut = srv.submit(obs, goal)
        time.sleep(0.05)
        fut.cancel()
        gate.set()
        out = srv.act(obs, goal, timeout=30)
    assert out.shape == (2,)


def test_close_fails_stragglers_instead_of_hanging(act):
    srv = BatchingActorServer(act, max_wait_ms=1.0)
    srv.close()
    fut = Future()
    srv._q.put((np.zeros((1, 32, 40), np.float32),
                np.zeros((1, 2), np.float32), True, fut))
    srv.close()
    with pytest.raises(RuntimeError, match="server closed"):
        fut.result(timeout=5)


def test_submit_after_close_raises(act):
    srv = BatchingActorServer(act, max_wait_ms=1.0)
    srv.close()
    with pytest.raises(RuntimeError, match="server closed"):
        srv.submit(np.zeros((32, 40), np.float32), np.zeros(2, np.float32))


def test_entry_point_without_cuda_raises(small_cfg, actor_params,
                                         monkeypatch):
    """No device argument means CUDA; without a card that raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_action_fn(small_cfg, actor_params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_serving_launches_no_kernel(act):
    got_forward_fused.launches = 0
    act(np.zeros((2, 32, 40), np.float32), np.zeros((2, 2), np.float32))
    assert got_forward_fused.launches == 0


def test_wrapper_rejects_unsupported_inputs(act):
    """The wrapper checks dtype, shape and device before any launch."""
    got = act.policy.trans
    pe, pos, blocks, fn = got.fused_params(torch.float32)
    patches = torch.zeros(2, got.num_patches, 320)
    goal = torch.zeros(2, 16)
    args = (pe, pos, blocks, fn, got.heads, got.dim_head,
            got.num_patches + 1, "rms")
    with pytest.raises(TypeError, match="fp32 or bf16"):
        got_forward_fused(patches.half(), goal.half(), *args)
    with pytest.raises(ValueError, match="shape"):
        got_forward_fused(patches[:, :, :300].contiguous(), goal, *args)
    with pytest.raises(ValueError, match="n_valid"):
        got_forward_fused(patches, goal, *args[:-2], 3, "rms")
    with pytest.raises(ValueError, match="final_norm"):
        got_forward_fused(patches, goal, *args[:-1], "batch")
