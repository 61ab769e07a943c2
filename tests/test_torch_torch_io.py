"""Reference PyTorch checkpoints into the port (dgvit_tpu_torch/models/
torch_io.py) against the JAX package's transplant, on the CPU.

No reference checkpoint is in the repo, so the state dicts are built from
the key map itself (the reference's module paths and torch layouts,
extra keys the reference's forward never reads included), drawn from a
numpy seed. Each goes through the JAX package's torch_io into its
module and through the port's into the port's; both must give the same
actions and Q values. Tolerance: fp32, rtol 1e-5, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.models import policies as jpol
from dgvit_tpu.models import torch_io as jtorch_io
from dgvit_tpu_torch.models import policies, torch_io

TOL = dict(rtol=1e-5, atol=1e-5)
B, HW = 3, (32, 40)
D, HEADS, DH, MLP, DEPTH = 32, 2, 16, 64, 2
GOT = dict(block=DEPTH, head=HEADS, l_f_size=D, dim_head=DH, mlp_dim=MLP,
           image_size=HW, emb_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are small, and beside the other
    test workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def linear(name, fan_in, fan_out, bias=True):
    return {f"{name}.weight": (fan_out, fan_in),
            **({f"{name}.bias": (fan_out,)} if bias else {})}


def got_trunk_keys():
    inner, n = HEADS * DH, (HW[0] // 16) * (HW[1] // 20)
    keys = {**linear("trans.to_patch_embedding.1", 320, D),
            "trans.pos_embedding": (1, n + 1, D),
            "trans.cls_token": (1, 1, D), "trans.layer_norm.g": (D,),
            **linear("trans.mlp_head.1", D, 2)}
    for i in range(DEPTH):
        lp = f"trans.transformer.layers.{i}."
        keys.update({f"{lp}0.norm.weight": (D,), f"{lp}0.norm.bias": (D,),
                     **linear(lp + "0.fn.to_qkv", D, 3 * inner, bias=False),
                     **linear(lp + "0.fn.to_out.0", inner, D),
                     f"{lp}1.norm.weight": (D,), f"{lp}1.norm.bias": (D,),
                     **linear(lp + "1.fn.net.0", D, MLP),
                     **linear(lp + "1.fn.net.3", MLP, D)})
    return keys


def conv_keys(channels):
    keys = {}
    for i, (ci, co) in enumerate(((channels, 16), (16, 64), (64, 256))):
        keys.update({f"conv{i + 1}.weight": (co, ci, 5, 5),
                     f"conv{i + 1}.bias": (co,)})
    return keys


def twin_keys(width):
    keys = {}
    for names in (("fc1", "fc2", "fc3"), ("fc11", "fc21", "fc31")):
        for name, fi, fo in zip(names, (width, 128, 32), (128, 32, 2)):
            keys.update(linear(name, fi, fo))
    return keys


CASES = {   # name -> (reference keys, frame shape, the JAX and port maps)
    "got_actor": ({**linear("fc_embed", 2, D), **got_trunk_keys(),
                   **linear("fc1", D, 128), **linear("fc2", 128, 128),
                   **linear("mean_linear", 128, 2),
                   **linear("log_std_linear", 128, 2)}, HW),
    "got_critic": ({**linear("fc_embed", 2, D), **got_trunk_keys(),
                    **twin_keys(D + 2)}, HW),
    "cnn_gaussian": ({**conv_keys(1), **linear("fc_embed", 2, 32),
                      **linear("fc1", 288, 128), **linear("fc2", 128, 32),
                      **linear("mean_linear", 32, 2),
                      **linear("log_std_linear", 32, 2)}, (29, 37)),
    "cnn_deterministic": ({**conv_keys(4), **linear("fc_embed", 2, 32),
                           **linear("fc1", 288, 128),
                           **linear("fc2", 128, 32),
                           **linear("mean", 32, 2)}, (29, 37, 4)),
    "cnn_critic": ({**conv_keys(1), **linear("fc_embed", 2, 32),
                    **twin_keys(290)}, (29, 37)),
}


def state_dict(keys, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.uniform(-0.3, 0.3, s).astype(np.float32))
            for k, s in keys.items()}


def networks(name, sd):
    """(JAX module, JAX params, port module with the port's map loaded)."""
    if name == "got_actor":
        jm, params = jpol.GoTPolicy(**GOT), \
            jtorch_io.got_policy_params_from_torch(sd, depth=DEPTH)
        port = policies.GoTPolicy(**GOT)
        port.load_state_dict(torch_io.got_policy_state_from_torch(
            sd, depth=DEPTH))
    elif name == "got_critic":
        jm, params = jpol.GoTQNetwork(**GOT), \
            jtorch_io.got_q_params_from_torch(sd, depth=DEPTH)
        port = policies.GoTQNetwork(**GOT)
        port.load_state_dict(torch_io.got_q_state_from_torch(sd,
                                                             depth=DEPTH))
    elif name == "cnn_critic":
        jm, params = jpol.QNetwork(), jtorch_io.cnn_q_params_from_torch(sd)
        port = policies.QNetwork()
        port.load_state_dict(torch_io.cnn_q_state_from_torch(sd))
    else:
        det = name == "cnn_deterministic"
        key = "mean" if det else "mean_linear"
        jm = jpol.DeterministicPolicy() if det else jpol.GaussianPolicy()
        params = jtorch_io.cnn_policy_params_from_torch(sd, mean_key=key)
        port = (policies.DeterministicPolicy() if det
                else policies.GaussianPolicy())
        port.load_state_dict(torch_io.cnn_policy_state_from_torch(
            sd, mean_key=key))
    return jm, params, port


@pytest.mark.parametrize("name", list(CASES))
def test_reference_state_dict_lands_as_in_jax(name):
    keys, frame = CASES[name]
    sd = state_dict(keys, seed=len(name))
    jm, params, port = networks(name, sd)
    rng = np.random.default_rng(1)
    obs = rng.uniform(0, 1, (B, *frame)).astype(np.float32)
    goal = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    act = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    args = (obs, goal, act) if "critic" in name else (obs, goal)
    ref = jm.apply({"params": params}, *map(jnp.asarray, args))
    with torch.no_grad():
        out = port(*map(torch.from_numpy, args))
    if name in ("got_actor", "cnn_gaussian"):      # the actions
        ref, out = (jnp.tanh(ref[0]),), (torch.tanh(out[0]),)
    elif name == "cnn_deterministic":
        ref, out = (ref,), (out,)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


def test_load_pth_checkpoints(tmp_path):
    """`load_actor_pth` / `load_critic_pth` read a saved reference state
    dict with weights_only and map it as the JAX package's do."""
    for name, load, jload in (
            ("got_actor", torch_io.load_actor_pth, jtorch_io.load_actor_pth),
            ("got_critic", torch_io.load_critic_pth,
             jtorch_io.load_critic_pth)):
        sd = state_dict(CASES[name][0], seed=3)
        path = tmp_path / f"{name}.pth"
        torch.save(sd, path)
        port = load(str(path), depth=DEPTH)
        _, params, ref = networks(name, sd)
        assert set(port) == set(ref.state_dict())
        for k, v in ref.state_dict().items():
            torch.testing.assert_close(port[k], v, rtol=0, atol=0)
        assert jload(str(path), depth=DEPTH).keys() == params.keys()
