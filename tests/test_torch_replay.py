"""The port's replay buffer and batch staging (dgvit_tpu_torch/replay)
against the JAX package's, on the CPU.

Both packages wrap the same C++ core (each its own copy, built by the same
compiler here), so a buffer of the same seed fed the same transitions must
return the same sampled indices and rows, bit for bit. Nothing waits on a
thread without a timeout.
"""

import time

import numpy as np
import pytest
import torch

from dgvit_tpu.replay import buffer as jb
from dgvit_tpu_torch.replay import (BatchPrefetcher, PrioritizedReplayBuffer,
                                    ReplayBuffer, reference_schema)
from dgvit_tpu_torch.replay.staging import HostStager

OBS = (6, 8)


def transition(rng, i, expert=False):
    f = lambda *s: rng.random(s).astype(np.float32)
    t = dict(obs=f(*OBS), pobs=f(2), next_pobs=f(2), rew=float(i),
             next_obs=f(*OBS), done=float(i % 5 == 0))
    t["act_exp" if expert else "act"] = f(2)
    if not expert:
        t["engage"] = 0.0
    return t


def fill(bufs, n, seed=0, expert=False):
    rng = np.random.default_rng(seed)
    for i in range(n):
        t = transition(rng, i, expert)
        for b in bufs:
            b.add(**t)


def same_batch(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("expert", [False, True])
def test_reference_schema(expert):
    assert reference_schema(OBS, 2, 2, expert) == \
        jb.reference_schema(OBS, 2, 2, expert)
    assert reference_schema() == jb.reference_schema()


@pytest.mark.parametrize("seed,stored", [(0, 10), (5, 16), (11, 40)])
def test_uniform_sampling_matches_jax_package(seed, stored):
    """Same seed, same transitions: the same rows, also after the ring has
    wrapped (capacity 16)."""
    port = ReplayBuffer(16, reference_schema(OBS), seed=seed)
    ref = jb.ReplayBuffer(16, jb.reference_schema(OBS), seed=seed)
    fill((port, ref), stored, seed)
    assert port.get_stored_size() == ref.get_stored_size() == min(stored, 16)
    for n in (4, 9, 32):
        same_batch(port.sample(n), ref.sample(n))


def test_prioritized_sampling_matches_jax_package():
    port = PrioritizedReplayBuffer(32, reference_schema(OBS), seed=3)
    ref = jb.PrioritizedReplayBuffer(32, jb.reference_schema(OBS), seed=3)
    fill((port, ref), 20)
    a, b = port.sample(8), ref.sample(8)
    same_batch(a, b)
    prio = np.linspace(0.1, 2.0, 8)
    port.update_priorities(a["indexes"], prio)
    ref.update_priorities(b["indexes"], prio)
    same_batch(port.sample(16, beta=0.7), ref.sample(16, beta=0.7))
    assert port.prioritized and not ReplayBuffer.prioritized


def test_ring_overwrite_keeps_the_newest():
    buf = ReplayBuffer(8, reference_schema(OBS), seed=1)
    fill((buf,), 21)
    assert buf.get_stored_size() == 8
    rew = buf.sample(200)["rew"]
    assert rew.shape == (200, 1)
    assert set(rew.ravel().astype(int)) == set(range(13, 21))


def test_batched_add_and_errors():
    buf = ReplayBuffer(16, reference_schema(OBS), seed=1)
    rng = np.random.default_rng(2)
    n = buf.add(obs=rng.random((5, *OBS)), act=rng.random((5, 2)),
                pobs=rng.random((5, 2)), next_pobs=rng.random((5, 2)),
                rew=np.arange(5.0), next_obs=rng.random((5, *OBS)),
                done=np.zeros(5), engage=np.zeros(5))
    assert n == 5 and buf.get_stored_size() == 5
    with pytest.raises(KeyError, match="engage"):
        buf.add(**{k: v for k, v in transition(rng, 0).items()
                   if k != "engage"})
    with pytest.raises(ValueError, match="obs"):
        buf.add(**{**transition(rng, 0), "obs": np.zeros((3, 3))})
    with pytest.raises(ValueError, match="empty"):
        ReplayBuffer(4, reference_schema(OBS)).sample(2)


def test_save_and_load_transitions(tmp_path):
    buf = ReplayBuffer(8, reference_schema(OBS), seed=4)
    ref = jb.ReplayBuffer(8, jb.reference_schema(OBS), seed=4)
    fill((buf, ref), 13)
    buf.save_transitions(str(tmp_path / "port"))
    ref.save_transitions(str(tmp_path / "jax"))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    # FIFO order, oldest first
    np.testing.assert_array_equal(a["rew"], np.arange(5.0, 13.0))
    warm = ReplayBuffer(8, reference_schema(OBS), seed=4)
    warm.load_transitions(str(tmp_path / "jax.npz"))
    assert warm.get_stored_size() == 8
    assert set(warm.sample(100)["rew"].ravel().astype(int)) == set(range(5, 13))


def test_library_builds_from_source_into_build_dir():
    from dgvit_tpu_torch.replay import buffer as pb

    lib = pb._build_lib()
    assert lib.parent == pb._BUILD_DIR and lib.exists()
    assert lib.parent.parent.name == "build"      # git-ignored
    assert not list((pb._SRC.parent).glob("*.so"))  # nothing beside the source


def test_host_stager_on_cpu():
    stager = HostStager("cpu")
    batch = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": np.ones((2, 1), np.float64)[:, ::1]}
    out, event = stager.put(batch)
    assert event is None
    assert torch.equal(out["a"], torch.arange(6.0).reshape(2, 3))
    assert out["b"].dtype == torch.float64


def test_prefetcher_on_cpu_hands_tensors_over():
    buf = ReplayBuffer(32, reference_schema(OBS), seed=6)
    fill((buf,), 20)
    calls = []

    def sample():
        calls.append(1)
        return buf.sample(4)

    pf = BatchPrefetcher(sample, depth=2, device="cpu")
    try:
        for _ in range(5):
            batch = next(pf)
            assert isinstance(batch["obs"], torch.Tensor)
            assert batch["obs"].shape == (4, *OBS)
            assert batch["rew"].shape == (4, 1)
        # the env loop adds while the thread samples
        fill((buf,), 5, seed=9)
        assert next(pf)["act"].shape == (4, 2)
    finally:
        pf.close(timeout=5.0)
    assert not pf._thread.is_alive()
    assert len(calls) >= 6
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_runs_ahead_by_its_depth_only():
    made = []

    def sample():
        made.append(len(made))
        return {"x": np.full((1,), len(made), np.float32)}

    pf = BatchPrefetcher(sample, depth=2, device="cpu")
    try:
        deadline = time.time() + 5.0
        while len(made) < 3 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        # two queued and one in the worker's hand, no more
        assert len(made) == 3
        assert [int(next(pf)["x"][0]) for _ in range(3)] == [1, 2, 3]
    finally:
        pf.close(timeout=5.0)
    assert not pf._thread.is_alive()


def test_prefetcher_surfaces_a_sampler_failure():
    def sample():
        raise ValueError("replay is empty")

    pf = BatchPrefetcher(sample, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="sample_fn failed") as err:
            next(pf)
        assert isinstance(err.value.__cause__, ValueError)
    finally:
        pf.close(timeout=5.0)
    assert not pf._thread.is_alive()


def test_staging_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HostStager()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchPrefetcher(lambda: {})
