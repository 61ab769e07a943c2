"""The port's elastic training (`core/elastic.py`, `train_rl.train_elastic`)
on the CPU: the cases of tests/test_elastic.py (the JAX package's) in
the port, and the 2-rank checkpointer (the counterpart of
tests/test_multiprocess.py's two-process checkpoint cases).

In this process: a fault resumes bit-exactly from the newest periodic
checkpoint, the restart budget holds, a non-designated error propagates,
retention keeps the newest, the designated failures, the offline trainer
resumes from the checkpointer, and `train_elastic` survives an env fault.
One job of 2 gloo ranks (tests/torch_dp_worker.py): 9 data-parallel
updates with emb-dropout live, a SimulatedFault after update 5 on the
first attempt, `run_elastic` resuming from the checkpoint of update 3
and ending bit-equal to the unbroken run; the checkpointer's barriers
(the late rank holds the early one in `save`, rank 0 writes, both read
the same path); and a world-2 checkpoint resumed at world 1 under
`reshard_state`, whose next update is held to the world-2 run's next
update (tests/test_torch_shard.py's tolerances).
"""

import numpy as np
import pytest
import torch

import torch_dp_worker
from dgvit_tpu_torch.agents import SACAgent
from dgvit_tpu_torch.config import Config
from dgvit_tpu_torch.core.elastic import (ElasticCheckpointer,
                                          SimulatedFault,
                                          default_failure_types,
                                          reshard_state, run_elastic)
from dgvit_tpu_torch.core.mesh import MeshRuntime
from dgvit_tpu_torch.envs import KinematicNavEnv
from dgvit_tpu_torch.envs.kinematic import default_records
from dgvit_tpu_torch.train import train_rl
from test_torch_shard import CFG, METRIC_TOL, make_batch

N_STEPS, B = 8, 4
UPDATES, FAULT_AFTER = 9, 5       # checkpoints every 3: resume from 3


def tiny_cfg():
    return Config.from_dict({
        "model": {"block": 1, "head": 2, "latent_size": 32, "mlp_dim": 64,
                  "image_size": (32, 40), "patch_size": (16, 20)},
        "sac": {"batch_size": B}})


def step_batch(step, b=B):
    """A step-keyed batch: the elastic-resume contract."""
    return make_batch(1000 + step, b)


def _train(agent, state, start, ck, fail_at=None):
    for step in range(start, N_STEPS):
        if fail_at is not None and step == fail_at:
            raise SimulatedFault(f"injected at step {step}")
        state, _ = agent.learn(state, step_batch(step))
        ck.maybe_save(step + 1, state)
    return state


@pytest.fixture(scope="module")
def agent():
    return SACAgent(tiny_cfg(), device="cpu", seed=0)


def _leaves(state):
    return [p.detach() for m in (state.actor, state.critic,
                                 state.critic_target)
            for p in m.parameters()] + [state.log_alpha.detach()]


def test_fault_resume_bit_exact(agent, tmp_path):
    ref = _train(agent, agent.init_state(),
                 0, ElasticCheckpointer(tmp_path / "ref", interval=100))
    ck = ElasticCheckpointer(tmp_path / "elastic", interval=3)
    attempts = []

    def train_fn(state, start, c):
        attempts.append(start)
        return _train(agent, state, start, c,
                      fail_at=5 if len(attempts) == 1 else None)

    final = run_elastic(train_fn, agent.init_state, ck, max_restarts=2)
    assert attempts == [0, 3]
    for a, b in zip(_leaves(final), _leaves(ref)):
        assert torch.equal(a, b)
    assert torch.equal(final.generator.get_state(), ref.generator.get_state())


def test_restart_budget_enforced(agent, tmp_path):
    ck = ElasticCheckpointer(tmp_path / "budget", interval=2)
    calls = []

    def always_fails(state, start, c):
        calls.append(start)
        raise SimulatedFault("persistent")

    with pytest.raises(SimulatedFault):
        run_elastic(always_fails, agent.init_state, ck, max_restarts=2)
    assert len(calls) == 3       # the first run and 2 restarts


@pytest.mark.parametrize("error", [ValueError, RuntimeError])
def test_non_designated_errors_propagate(agent, tmp_path, error):
    ck = ElasticCheckpointer(tmp_path / "bug", interval=2)
    calls = []

    def buggy(state, start, c):
        calls.append(start)
        raise error("an ordinary bug: never retried")

    with pytest.raises(error):
        run_elastic(buggy, agent.init_state, ck, max_restarts=5)
    assert calls == [0]


def test_retention_pruning(agent, tmp_path):
    ck = ElasticCheckpointer(tmp_path / "keep", interval=1, keep=2)
    state = agent.init_state()
    for step in (1, 2, 3, 4):
        ck.save(step, state)
    assert sorted(p.name for p in (tmp_path / "keep").iterdir()) == \
        ["step_3", "step_4"]
    assert ck.maybe_save(0, state) is None and ck.maybe_save(5, state)


def test_failure_types():
    names = [t.__name__ for t in default_failure_types()]
    assert names[0] == "SimulatedFault"
    assert ("AcceleratorError" in names) == hasattr(torch, "AcceleratorError")
    assert not any(issubclass(ValueError, t) or t is RuntimeError
                   for t in default_failure_types())


def test_offline_trainer_resumes_from_checkpointer(tmp_path):
    """train_offline with a checkpointer: a second call starts at the
    saved step instead of step 0."""
    from dgvit_tpu_torch.replay import PrioritizedReplayBuffer
    from dgvit_tpu_torch.replay import reference_schema
    from dgvit_tpu_torch.train.train_offline import train_offline

    cfg = tiny_cfg()
    buf = PrioritizedReplayBuffer(64, reference_schema((32, 40), 2, 2),
                                  seed=0)
    b0 = step_batch(0, b=16)
    buf.add(obs=b0["obs"], act=b0["act"], pobs=b0["pobs"],
            next_pobs=b0["next_pobs"], rew=b0["rew"].ravel(),
            next_obs=b0["next_obs"], done=np.zeros(16, np.float32),
            engage=np.zeros(16, np.float32))
    ck = ElasticCheckpointer(tmp_path / "off", interval=2)
    state, _ = train_offline(cfg, buf, steps=4, out_dir=str(tmp_path),
                             checkpointer=ck, device="cpu")
    assert state.itera == 4
    state2, _ = train_offline(cfg, buf, steps=6, out_dir=str(tmp_path),
                              checkpointer=ck, device="cpu")
    assert state2.itera == 6          # 2 more from the step-4 checkpoint


def test_train_elastic_survives_an_env_fault(tmp_path):
    """The RL trainer under the supervisor: the env dies mid-run on the
    first attempt; training restarts from the periodic checkpoint with a
    rebuilt env and completes."""
    cfg = Config.from_dict({
        "model": {"block": 1, "head": 2, "latent_size": 32, "mlp_dim": 64,
                  "image_size": (32, 40), "patch_size": (16, 20)},
        "sac": {"batch_size": 4, "buffer_size": 256},
        "env": {"max_steps": 10, "max_episodes": 3},
        "train": {"pre_buffer": False, "plot_interval": 1000,
                  "eval_threshold": 0, "reward_threshold": 1e9,
                  "save_interval": 1}})
    records = default_records(seed=0)
    built = []

    class FaultyEnv:
        def __init__(self, inner, fail):
            self._inner, self._fail, self._n = inner, fail, 0

        def __getattr__(self, k):
            return getattr(self._inner, k)

        def step(self, *a, **kw):
            self._n += 1
            if self._fail and self._n == 15:
                raise SimulatedFault("env died mid-episode")
            return self._inner.step(*a, **kw)

    def factory():
        env = FaultyEnv(KinematicNavEnv(records, image_hw=(32, 40)),
                        fail=not built)
        built.append(env)
        return env

    out = train_rl.train_elastic(cfg, factory, out_dir=str(tmp_path),
                                 max_restarts=2, max_episodes=3,
                                 device="cpu")
    assert len(built) == 2, "expected exactly one restart"
    assert out["episodes"] >= 1
    assert list((tmp_path / "checkpoints").glob("step_*"))


def test_train_elastic_raises_past_its_budget(tmp_path):
    class Dead:
        def reset(self, *a, **kw):
            raise SimulatedFault("no env")

    built = []

    def factory():
        built.append(1)
        return Dead()

    with pytest.raises(SimulatedFault):
        train_rl.train_elastic(tiny_cfg(), factory, out_dir=str(tmp_path),
                               max_restarts=1, max_episodes=1, device="cpu")
    assert len(built) == 2


# --------------------------------------------------------------------------
# two ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    rng = np.random.default_rng(5)
    torch.save({"cfg": CFG, "updates": UPDATES, "fault_after": FAULT_AFTER,
                "batches": [make_batch(500 + u) for u in range(UPDATES)],
                "noise": [tuple(rng.normal(size=(16, 2)).astype(np.float32)
                                for _ in range(2)) for _ in range(2)]},
               d / "inputs.pt")
    return d, torch_dp_worker.launch("elastic", 2, d)


def test_two_rank_fault_resumes_bit_exact(ranks):
    """9 updates with emb-dropout live; a fault after update 5 on the
    first attempt; the resume from the checkpoint of update 3 ends
    bit-equal to the unbroken run, on both ranks, with the newest 2
    checkpoints kept."""
    _, outs = ranks
    for out in outs:
        assert out["attempts"] == [0, 3]
        for kind in ("actor", "critic", "critic_target"):
            for n, x in out["ref"][kind].items():
                assert torch.equal(x, out["final"][kind][n]), f"{kind}.{n}"
        assert out["ref"]["log_alpha"] == out["final"]["log_alpha"]
        assert out["final"]["itera"] == UPDATES
        assert torch.equal(out["ref_generator"], out["final_generator"])
        assert out["kept"] == ["step_6", "step_9"]
    for n, x in outs[0]["final"]["actor"].items():
        assert torch.equal(x, outs[1]["final"]["actor"][n])


def test_two_rank_checkpointer_barriers(ranks):
    """Rank 1 enters save 1 s late: rank 0 does not leave before it
    arrives; one path, written whole when either leaves; both resume at
    its step."""
    _, outs = ranks
    early, late = outs[0]["barrier"], outs[1]["barrier"]
    assert early["out"] >= late["in"] - 0.05
    assert early["path"] == late["path"]
    for b in (early, late):
        assert b["whole"] and b["start"] == 5 and b["itera"] == UPDATES


def test_world_2_checkpoint_resumes_at_world_1(ranks):
    """The world-2 checkpoint of update 1, restored into a one-process
    agent and placed by reshard_state: its next update against the
    world-2 run's next update."""
    d, outs = ranks
    inp = torch.load(d / "inputs.pt", weights_only=False)
    agent = SACAgent(Config.from_dict(CFG), device="cpu", seed=3)
    state, start = ElasticCheckpointer(d / "topo").resume(agent.init_state())
    assert start == 1 == outs[0]["topology"]["start"]
    state = reshard_state(state, MeshRuntime.create(device="cpu"))
    state, m = agent.learn(state, inp["batches"][1], noise=inp["noise"][1])
    ref = outs[0]["topology"]
    for k, v in ref["metrics"].items():
        assert float(m[k]) == pytest.approx(v, **METRIC_TOL), k
    for kind in ("actor", "critic", "critic_target"):
        for n, p in getattr(state, kind).named_parameters():
            x, r = p.detach().numpy(), ref["state"][kind][n].numpy()
            assert np.isclose(x, r, atol=5e-6, rtol=1e-4).mean() >= 0.995
            assert np.abs(x - r).max() <= 2.2e-3
    assert state.itera == ref["state"]["itera"] == 2
