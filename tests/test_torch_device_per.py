"""The port's on-device prioritized replay
(dgvit_tpu_torch/replay/device_per.py) against the JAX package's
`replay/device_per.py`, on the CPU, and the mirrors of
tests/test_device_per.py.

Tolerances: the priority state (p^alpha of fp32 on both sides) exactly,
or within rtol 1e-6 where a pow is taken (the two libraries' fp32 pow may
round the last place apart); indices equal to JAX's for the same uniform
draws u, except that a draw whose u * total lies within 4 ulps of a
boundary of the cumulative sums may take the neighbouring row (a scan
rounds the sums differently); importance weights rtol 1e-6 where the
indices agree. Duplicate rows in an update keep the last occurrence's
value, as XLA's CPU scatter and the C++ buffer's loop do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.replay import device_per as jper
from dgvit_tpu_torch.replay import device_per as per_mod
from dgvit_tpu_torch.replay.device_per import (ALPHA, last_wins, per_init,
                                               per_on_write, per_sample,
                                               per_update)

RTOL = 1e-6


def both_init(cap):
    return per_init(cap, "cpu"), jper.per_init(cap)


def assert_same_state(port, ref, rtol=RTOL):
    np.testing.assert_allclose(port.prios.numpy(), np.asarray(ref.prios),
                               rtol=rtol, atol=0)
    assert port.max_p.item() == pytest.approx(float(ref.max_p), rel=rtol)
    assert port.prios.dtype == torch.float32 and port.max_p.dim() == 0


def skewed(cap=64, stored=48, seed=0):
    """A state as a run leaves it: `stored` rows written, a few updates of
    skewed raw priorities, some rows at the write-time max."""
    rng = np.random.default_rng(seed)
    per, jp = both_init(cap)
    rows = np.arange(stored)
    per_on_write(per, torch.from_numpy(rows))
    jp = jper.per_on_write(jp, jnp.asarray(rows))
    for _ in range(3):
        idx = rng.integers(0, stored, 16)
        raw = rng.lognormal(0.0, 1.5, 16).astype(np.float32)
        per_update(per, torch.from_numpy(idx), torch.from_numpy(raw))
        jp = jper.per_update(jp, jnp.asarray(idx), jnp.asarray(raw))
    return per, jp


def test_init_write_update_equal_jax():
    per, jp = both_init(16)
    assert_same_state(per, jp, rtol=0)
    per_on_write(per, torch.arange(5))
    jp = jper.per_on_write(jp, jnp.arange(5))
    assert_same_state(per, jp, rtol=0)
    idx, raw = [1, 3], np.asarray([4.5, 0.25], np.float32)
    per_update(per, torch.as_tensor(idx), torch.from_numpy(raw))
    jp = jper.per_update(jp, jnp.asarray(idx), jnp.asarray(raw))
    assert_same_state(per, jp)
    # later writes inherit the raised max, wrapping rows included
    per_on_write(per, torch.as_tensor([14, 15, 0]))
    jp = jper.per_on_write(jp, jnp.asarray([14, 15, 0]))
    assert_same_state(per, jp)


def test_planted_duplicates_last_occurrence_wins():
    """Rows named twice or three times in one update take the value at
    their last batch position: the port, JAX and the explicit rule
    agree."""
    idx = np.asarray([3, 1, 3, 5, 1, 7, 3, 5], np.int64)
    raw = np.asarray([2.0, 3.0, 5.0, 7.0, 11.0, 13.0, 17.0, 0.5],
                     np.float32)
    per, jp = both_init(8)
    per_on_write(per, torch.arange(8))
    jp = jper.per_on_write(jp, jnp.arange(8))
    per_update(per, torch.from_numpy(idx), torch.from_numpy(raw))
    jp = jper.per_update(jp, jnp.asarray(idx), jnp.asarray(raw))
    assert_same_state(per, jp)
    want = np.ones(8, np.float32)
    for i, r in zip(idx, raw):       # the C++ buffer's loop: last wins
        want[i] = np.float32(r) ** np.float32(ALPHA)
    np.testing.assert_allclose(per.prios.numpy(), want, rtol=RTOL)
    assert per.max_p.item() == 17.0
    # last_wins alone: every duplicate carries its row's last value
    vals = torch.from_numpy(raw)
    np.testing.assert_array_equal(
        last_wins(torch.from_numpy(idx), vals, 8).numpy(),
        [17.0, 11.0, 17.0, 0.5, 11.0, 13.0, 17.0, 0.5])


def boundary_ok(got, want, u, total, cumsum):
    """Indices equal, or neighbours where u * total lies within 4 ulps of
    the boundary between them."""
    for g, w, x in zip(got, want, u * total):
        if g == w:
            continue
        assert abs(int(g) - int(w)) == 1, (g, w)
        edge = cumsum[min(g, w)]
        assert abs(x - edge) <= 4 * np.spacing(np.float32(edge)), (g, w, x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_with_jax_draws_gives_jax_rows_and_weights(seed):
    per, jp = skewed(seed=seed)
    assert_same_state(per, jp)
    key = jax.random.PRNGKey(100 + seed)
    stored = 48
    jidx, jw = jper.per_sample(jp, key, 256, jnp.int32(stored), beta=0.4)
    u = np.array(jax.random.uniform(key, (256,)))
    idx, w = per_sample(per, None, 256, stored, beta=0.4,
                        u=torch.from_numpy(u))
    jidx, jw = np.asarray(jidx), np.asarray(jw)
    c = np.cumsum(np.asarray(jp.prios), dtype=np.float32)
    boundary_ok(idx.numpy(), jidx, u, c[-1], c)
    same = idx.numpy() == jidx
    assert same.mean() > 0.95
    np.testing.assert_allclose(w.numpy()[same], jw[same], rtol=RTOL)
    assert idx.dtype == torch.int64 and w.dtype == torch.float32


def test_sample_draws_from_the_generator():
    per, _ = skewed()
    a = per_sample(per, torch.Generator().manual_seed(5), 64, 48)
    b = per_sample(per, torch.Generator().manual_seed(5), 64, 48)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[0].max()) < 48


# --------------------------------------------------------------------------
# mirrors of tests/test_device_per.py
# --------------------------------------------------------------------------

def test_write_and_update_semantics():
    """Mirrors tests/test_device_per.py:13."""
    per = per_init(8, "cpu")
    assert per.max_p.item() == 1.0
    per_on_write(per, torch.as_tensor([0, 1, 2]))
    np.testing.assert_allclose(per.prios.numpy()[:3], 1.0)
    per_update(per, torch.as_tensor([1]), torch.as_tensor([5.0]))
    assert per.max_p.item() == pytest.approx(5.0)
    assert per.prios[1].item() == pytest.approx(5.0 ** ALPHA, rel=1e-6)
    per_on_write(per, torch.as_tensor([3]))
    assert per.prios[3].item() == pytest.approx(5.0 ** ALPHA, rel=1e-6)


def test_sampling_proportional_and_excludes_empty():
    """Mirrors tests/test_device_per.py:29."""
    per = per_init(16, "cpu")
    per_on_write(per, torch.as_tensor([0, 1]))
    per_update(per, torch.as_tensor([0, 1]),
               torch.as_tensor([9.0 ** (1 / ALPHA), 1.0]))
    idx, _ = per_sample(per, torch.Generator().manual_seed(0), 4000, 2)
    idx = idx.numpy()
    assert set(np.unique(idx)) <= {0, 1}
    assert 0.85 < (idx == 0).mean() < 0.95


def test_uniform_priorities_give_unit_weights():
    """Mirrors tests/test_device_per.py:42."""
    per = per_init(8, "cpu")
    per_on_write(per, torch.arange(5))
    _, w = per_sample(per, torch.Generator().manual_seed(1), 64, 5)
    np.testing.assert_allclose(w.numpy(), 1.0, rtol=1e-5)


def test_is_weights_match_cpp_buffer():
    """Mirrors tests/test_device_per.py:49: the device weights equal the
    port's C++ buffer's (replay.cpp's formula) for each index."""
    from dgvit_tpu_torch.replay import PrioritizedReplayBuffer

    prios = np.asarray([0.5, 2.0, 7.0, 1.0], np.float64)
    host = PrioritizedReplayBuffer(8, {"x": {"shape": ()}}, seed=0)
    host.add(x=np.zeros(4, np.float32))
    host.update_priorities(np.arange(4), prios)
    host_w = {}
    for _ in range(200):
        out = host.sample(16, beta=0.4)
        for i, wi in zip(out["indexes"], out["weights"]):
            host_w[int(i)] = float(wi)
        if len(host_w) == 4:
            break
    assert len(host_w) == 4
    per = per_init(8, "cpu")
    per_on_write(per, torch.arange(4))
    per_update(per, torch.arange(4), torch.from_numpy(prios))
    idx, w = per_sample(per, torch.Generator().manual_seed(2), 512, 4,
                        beta=0.4)
    idx, w = idx.numpy(), w.numpy()
    for i in range(4):
        got = w[idx == i]
        assert got.size, f"index {i} never sampled"
        np.testing.assert_allclose(got, host_w[i], rtol=1e-4,
                                   err_msg=f"index {i}")


def test_no_host_reads_of_the_device_state(monkeypatch):
    """per_sample and per_update never turn a tensor into a host value
    (on the card that would be a synchronizing read)."""
    per, _ = skewed()

    def refuse(self, *a, **k):
        raise AssertionError("a host read of a tensor")

    for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    idx, _ = per_mod.per_sample(per, torch.Generator().manual_seed(0), 32,
                                48)
    per_mod.per_update(per, idx, torch.rand(32) + 1e-6)
