"""The float64-sum yardstick of chip_smoke.py's restated checks, and the
JAX oracles of ROADMAP faults 3c and 3d, on the CPU.

chip_smoke.py holds a kernel that differs from its plain version only in
the order of its sums to the plain version with every matrix product
summed in float64 (`exact_sums`), under max(old limit, k x the plain
version's own distance to it). These tests show that the mode reaches
every product of the plain versions and nothing else, that the restated
check passes float64 sums and fails a wrong rounding point, and hold the
plain versions of faults 3c (fp32 K2b) and 3d (the per-block chain against
the whole-trunk backward) against the JAX package's TPU kernels in
interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import chip_smoke as cs
from dgvit_tpu.ops.cls_block import cls_final_block
from dgvit_tpu.ops.fused_transformer import (_fused_block_bwd_impl,
                                             fused_transformer_block)
from dgvit_tpu.ops.got_megakernel import _final_norm32
from dgvit_tpu.ops.trunk_train import trunk_bwd_impl
from dgvit_tpu_torch.ops import cls_block as cb
from dgvit_tpu_torch.ops import fused_transformer as ft
from dgvit_tpu_torch.ops import got_megakernel as gm
from dgvit_tpu_torch.ops.fused_block import attention_section_plain
from dgvit_tpu_torch.ops.trunk_train import trunk_bwd_plain
from torch_kernel_cases import (D, DIM_HEAD, HEADS, MLP, block_tree, rand,
                                to_torch, weights)

MATMULS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
           torch.mm, torch.bmm}


class Products(TorchFunctionMode):
    """Records the dtype of every matrix product."""

    def __init__(self):
        super().__init__()
        self.dtypes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in MATMULS:
            self.dtypes.append(args[0].dtype)
        return func(*args, **(kwargs or {}))


def small_args(name, dtype="bfloat16"):
    """Arguments of one plain function at the small test geometry."""
    rng = np.random.default_rng(5)
    w = [weights(block_tree(rng), dtype)[1] for _ in range(2)]
    t = lambda *s: to_torch(rand(rng, *s), dtype)
    fn = (torch.from_numpy(1 + 0.1 * rand(rng, D)), torch.zeros(D))
    x, dy3 = t(3, 5, D), t(3, D)
    if name == "got_forward_plain":
        pe = (t(16, D), t(D))
        return (t(3, 4, 16), t(3, D), pe, t(5, D), w, fn, HEADS, DIM_HEAD,
                5, "rms")
    return {"blocks_forward_plain": (x, w, fn, HEADS, DIM_HEAD, "rms"),
            "block_bwd_plain": (x, t(3, 5, D), w[0], HEADS, DIM_HEAD),
            "cls_fwd_plain": (x, w[1], HEADS, DIM_HEAD),
            "cls_bwd_plain": (x, dy3, w[1], HEADS, DIM_HEAD),
            "attention_section_plain": (x, *w[0][2:5], HEADS, DIM_HEAD),
            "trunk_bwd_plain": (x, dy3, w, fn, HEADS, DIM_HEAD,
                                "rms")}[name]


PLAIN = {"blocks_forward_plain": gm.blocks_forward_plain,
         "got_forward_plain": gm.got_forward_plain,
         "block_bwd_plain": ft.block_bwd_plain,
         "cls_fwd_plain": cb.cls_fwd_plain,
         "cls_bwd_plain": cb.cls_bwd_plain,
         "attention_section_plain": attention_section_plain,
         "trunk_bwd_plain": trunk_bwd_plain}


def flat(result):
    if isinstance(result, torch.Tensor):
        return [result]
    out = []
    for r in result:
        out += flat(r) if isinstance(r, (tuple, list)) else [r]
    return out


@pytest.mark.parametrize("name", list(PLAIN))
def test_exact_sums_reaches_every_product(name):
    """Under exact_sums every matrix product of the plain function is a
    float64 product through the one hook (`fused_transformer._prod`): as
    many hook calls as products, none left in fp32. Outside it, the same
    products run in fp32."""
    args = small_args(name)
    calls = []
    hook = ft._prod
    with Products() as seen:
        PLAIN[name](*args)
    assert seen.dtypes and set(seen.dtypes) == {torch.float32}
    with cs.exact_sums():
        exact = ft._prod
        ft._prod = lambda a, b: calls.append(1) or exact(a, b)
        try:
            with Products() as under:
                PLAIN[name](*args)
        finally:
            ft._prod = exact
    assert ft._prod is hook
    assert set(under.dtypes) == {torch.float64}
    assert len(calls) == len(under.dtypes) == len(seen.dtypes)


@pytest.mark.parametrize("name", list(PLAIN))
def test_exact_sums_changes_nothing_outside(name):
    """The mode moves the results (the sums are other sums) and leaves
    nothing behind: after it, the plain function gives the same tensors as
    before, bit for bit, and the hook is the fp32 product again."""
    args = small_args(name, "float32")
    hook = ft._prod
    before = flat(PLAIN[name](*args))
    inside = flat(cs.exact(PLAIN[name], *args))
    after = flat(PLAIN[name](*args))
    assert ft._prod is hook
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert any(not torch.equal(a, b) for a, b in zip(before, inside))


def composed_got(dtype, monkeypatch):
    """A small seeded GoT on the composed route with K7 (block dropout
    0.1, the K7 branch entered by saying the tensor is on the card), its
    frames and goal tokens."""
    from dgvit_tpu_torch.models import layers
    from dgvit_tpu_torch.models.got import GoT

    monkeypatch.setattr(layers, "_on_card", lambda t: True)
    torch.manual_seed(0)
    got = GoT(image_size=(32, 40), patch_size=(16, 20), dim=D, depth=2,
              heads=HEADS, dim_head=DIM_HEAD, mlp_dim=MLP, dropout=0.1,
              dtype=getattr(torch, dtype))
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.uniform(0, 1, (3, 32, 40)).astype(np.float32))
    tok = torch.from_numpy(rand(rng, 3, D))
    return got, img, tok


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_sums_reaches_the_composed_route(dtype, monkeypatch):
    """The composed blocks' products (the qkv and output projections of
    `attention` outside K7, the MLP's two, `Linear`'s) go through
    `layers._prod`, K7's plain version through `fused_transformer._prod`:
    under exact_sums every matrix product of the composed route's forward
    is a float64 product, one hook call each; outside it none is, and
    after it the route gives the same bits as before (fp32: other bits
    inside it)."""
    from dgvit_tpu_torch.models import layers

    got, img, tok = composed_got(dtype, monkeypatch)
    hooks = ft._prod, layers._prod
    with torch.no_grad():
        with Products() as seen:
            before = got(img, tok)
        calls = []
        with cs.exact_sums():
            exact = ft._prod, layers._prod
            ft._prod = lambda a, b: calls.append(1) or exact[0](a, b)
            layers._prod = lambda a, b: calls.append(1) or exact[1](a, b)
            try:
                with Products() as under:
                    inside = got(img, tok)
            finally:
                ft._prod, layers._prod = exact
        after = got(img, tok)
    assert (ft._prod, layers._prod) == hooks
    assert seen.dtypes and torch.float64 not in seen.dtypes
    assert set(under.dtypes) == {torch.float64}
    assert len(calls) == len(under.dtypes) == len(seen.dtypes)
    assert torch.equal(before, after) and inside.dtype == before.dtype
    if dtype == "float32":   # bf16 rounds the other sums alike here
        assert not torch.equal(before, inside)


def test_exact_sums_reaches_the_composed_backward(monkeypatch):
    """Under exact_sums the composed route's gradients (autograd through
    `layers._prod` and K7's recompute of its plain version) move, and
    after it they are the same bits as before."""
    got, img, tok = composed_got("float32", monkeypatch)

    def grads():
        for p in got.parameters():
            p.grad = None
        got(img, tok).sum().backward()
        return [p.grad.clone() for p in got.parameters()]
    before = grads()
    with cs.exact_sums():
        inside = grads()
    after = grads()
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert any(not torch.equal(a, b) for a, b in zip(before, inside))


def test_restated_check_passes_exact_sums_and_fails_a_wrong_rounding():
    """chip_smoke.restated as a pure function of tensors: K4's pooled bf16
    check (k = EXACT_K["K4"]) passes the float64-sum output (0 against
    itself) and fails the plain version with the residual stream kept in
    fp32 across blocks (a wrong rounding point); the per-tensor fp32 check
    does the same with a bf16 rounding of the fp32 output."""
    rng = np.random.default_rng(11)
    w = [weights(block_tree(rng), "bfloat16")[1] for _ in range(3)]
    fn = (torch.from_numpy(1 + 0.1 * rand(rng, D)), torch.zeros(D))
    x = to_torch(rand(rng, 8, 5, D), "bfloat16")
    args = (x, w, fn, HEADS, DIM_HEAD, "rms")
    plain = gm.blocks_forward_plain(*args)
    exact = cs.exact(gm.blocks_forward_plain, *args)
    wrong = cs.k4_f32_residual(*args)
    k = cs.EXACT_K["K4"]
    ok, got, limit = cs.restated(cs.pooled_rel, cs.TRAIN_BF16_MEAN, k,
                                 [exact], [plain], [exact])
    assert ok and got == 0.0 and limit >= cs.TRAIN_BF16_MEAN
    ok, got, _ = cs.restated(cs.pooled_rel, cs.TRAIN_BF16_MEAN, k, [wrong],
                             [plain], [exact])
    assert not ok and got > 10 * cs.TRAIN_BF16_MEAN
    xs = to_torch(rand(rng, 3, 5, D), "float32")
    w32 = weights(block_tree(rng), "float32")[1]
    out = ft.block_fwd_plain(xs, w32, HEADS, DIM_HEAD)
    ex = cs.exact(ft.block_fwd_plain, xs, w32, HEADS, DIM_HEAD)
    assert cs.restated(cs.rel_max, cs.TRAIN_F32_MAX, cs.EXACT_K["fp32"],
                       [ex], [out], [ex])[0]
    assert not cs.restated(cs.rel_max, cs.TRAIN_F32_MAX, cs.EXACT_K["fp32"],
                           [out.bfloat16().float()], [out], [ex])[0]


def test_gap_q_rule_passes_plain_and_fails_autograd():
    """Phase 5's bf16 K2b rule (gap q, chip_smoke.k2b_bf16_rule) as a pure
    function of tensors, on one small CPU draw (8 frames of 17 tokens):
    the plain version holds every dx frame within 2^-18 of the float64-sum
    version and its tensors within the pooled limit; autograd of the plain
    forward (the wrong rounding points) holds no frame and fails the
    pooled limit."""
    rng = np.random.default_rng(1)
    w = weights(block_tree(rng), "bfloat16")[1]
    x, dy = (to_torch(rand(rng, 8, 17, D), "bfloat16") for _ in range(2))
    args = (x, dy, w, HEADS, DIM_HEAD)
    plain = cs.tensors(ft.block_bwd_plain(*args))
    wrong = cs.tensors(cs.autograd_bwd(ft.block_fwd_plain)(*args))
    ex = cs.tensors(cs.exact(ft.block_bwd_plain, *args))
    within, pooled, limit, verdict, frames, _ = cs.k2b_bf16_rule(
        [({"plain": plain, "autograd": wrong, "float64 sums": ex}, ex)])
    assert frames == 8 and limit >= cs.TRAIN_BF16_MEAN
    assert verdict == {"plain": True, "autograd": False,
                       "float64 sums": True}
    assert within["plain"] == within["float64 sums"] == 1.0
    assert within["autograd"] < cs.CHAIN_WITHIN
    assert pooled["autograd"] > 10 * limit


def test_gap_r_rule_passes_exact_sums_and_fails_the_wrong_blocks():
    """Phase 5's fp32 K2b rule (gap r, chip_smoke.f32_rule) as a pure
    function of tensors, on one small CPU draw: against the plain version
    evaluated in float64 throughout (`float64_eval`), the pooled
    mean|err|/L passes the plain and the float64-sum versions and fails the
    tanh GELU and the block whose scores are scaled 1 / dim_head."""
    rng = np.random.default_rng(1)
    w = weights(block_tree(rng), "float32")[1]
    x, dy = (to_torch(rand(rng, 2, 17, D), "float32") for _ in range(2))
    args = (x, dy, w, HEADS, DIM_HEAD)
    versions = {"plain": cs.tensors(ft.block_bwd_plain(*args)),
                "float64 sums": cs.tensors(cs.exact(ft.block_bwd_plain,
                                                    *args)),
                **{what: cs.tensors(fn(*args))
                   for what, fn in cs.F32_BLOCK_WRONGS.items()}}
    yard = cs.tensors(cs.float64_eval(ft.block_bwd_plain, *args))
    _, pooled, limit, _, _, verdict = cs.f32_rule("K2b", [(versions, yard)])
    assert limit >= cs.F32_POOLED
    assert verdict == {"plain": True, "float64 sums": True,
                       "tanh GELU": False,
                       "scores scaled 1 / dim_head": False}
    assert min(pooled[w] for w in cs.F32_BLOCK_WRONGS) > 10 * limit


@pytest.mark.parametrize("name", ["K3f", "K3b"])
def test_gap_t_rule_passes_exact_sums_and_fails_the_wrong_blocks(name):
    """Phase 5's fp32 K3f and K3b rule (gap t, chip_smoke.f32_rule) as a
    pure function of tensors, on one small CPU draw: against the plain
    version evaluated in float64 throughout (`float64_eval`; K3b's
    recomputing its CLS row), the pooled mean|err|/L passes the plain and
    the float64-sum versions and fails the tanh GELU and the block whose
    scores are scaled 1 / dim_head."""
    rng = np.random.default_rng(2)
    w = weights(block_tree(rng), "float32")[1]
    x = to_torch(rand(rng, 2, 17, D), "float32")
    dy = to_torch(rand(rng, 2, D), "float32")
    if name == "K3f":
        plain, args, wrongs = (cb.cls_fwd_plain, (x, w, HEADS, DIM_HEAD),
                               cs.F32_CLS_FWD_WRONGS)
        yard = cs.tensors(cs.float64_eval(plain, x, None, w, HEADS,
                                          DIM_HEAD))
    else:
        plain, args, wrongs = (cb.cls_bwd_plain, (x, dy, w, HEADS, DIM_HEAD),
                               cs.F32_CLS_BWD_WRONGS)
        yard = cs.tensors(cs.float64_eval(plain, *args))
    versions = {"plain": cs.tensors(plain(*args)),
                "float64 sums": cs.tensors(cs.exact(plain, *args)),
                **{what: cs.tensors(fn(*args)) for what, fn in wrongs.items()}}
    assert all(t.dtype == torch.float64 for t in yard)
    _, pooled, limit, _, _, verdict = cs.f32_rule(name, [(versions, yard)])
    assert limit >= cs.F32_POOLED
    assert verdict == {"plain": True, "float64 sums": True,
                       "tanh GELU": False,
                       "scores scaled 1 / dim_head": False}
    assert min(pooled[w] for w in wrongs) > 10 * limit


def test_gap_s_rule_passes_exact_sums_and_fails_the_wrong_trunks():
    """Phase 2's pooled fp32 check of K1's latent (gap s, f32_rule "K1")
    as a pure function of tensors, on one small CPU draw: against K1's
    float64-sum version, the plain version and the float64-sum version
    pass, the tanh GELU and the trunk whose scores are scaled 1 / dim_head
    fail."""
    args = small_args("got_forward_plain", "float32")
    plain = gm.got_forward_plain(*args)
    ex = cs.exact(gm.got_forward_plain, *args)
    versions = {"plain": [plain], "float64 sums": [ex],
                **{what: [fn(*args)] for what, fn in cs.K1_F32_WRONGS.items()}}
    _, pooled, limit, _, _, verdict = cs.f32_rule("K1", [(versions, [ex])])
    assert limit >= cs.F32_POOLED
    assert verdict == {"plain": True, "float64 sums": True,
                       "tanh GELU": False,
                       "scores scaled 1 / dim_head": False}
    assert min(pooled["tanh GELU"],
               pooled["scores scaled 1 / dim_head"]) > 10 * limit


@pytest.fixture(scope="module")
def actor_nets():
    saved = cs.DEVICE
    cs.DEVICE = "cpu"
    try:
        yield cs.build_nets(*cs.golden_params())
    finally:
        cs.DEVICE = saved


def to_jax_flat(w):
    return tuple(jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        .reshape((1, -1) if t.dim() == 1 else tuple(t.shape)) for t in w)


def test_fault_3c_fp32_block_backward_against_the_jax_kernel(actor_nets,
                                                            monkeypatch):
    """Fault 3c's oracle: the port's fp32 `block_bwd_plain` against the JAX
    `_fused_block_bwd_impl` in interpret mode, on the trained actor's
    first block at B=8 (65 tokens, seeded frames and gradient, as phase 5
    draws them). Another fp32 summation order through a trunk whose
    activations reach 1e4: each tensor within 1e-4 L of the JAX kernel
    (read 1.54e-5 L on the LayerNorm scale gradient, past the old 1e-5 L
    that chip_smoke.py held the CUDA kernel to). The JAX kernel itself
    meets the restated fp32 check against the port's float64-sum version
    (read 5.1e-6 L there, the port's plain version 1.1e-5 L)."""
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    a = cs.train_inputs(actor_nets["float32"], 8,
                        np.random.default_rng(7))["actor"]
    x, dy, w = a["x"], a["dy2"], a["blocks"][0]
    dx, dflat = _fused_block_bwd_impl(
        jnp.asarray(x.numpy()), jnp.asarray(dy.numpy()), to_jax_flat(w),
        heads=a["heads"], dim_head=a["dh"], interpret=True)
    port = cs.tensors(ft.block_bwd_plain(x, dy, w, a["heads"], a["dh"]))
    jx = [torch.from_numpy(np.array(t, np.float32)).reshape(p.shape)
          for t, p in zip([dx, *dflat], port)]
    exact = cs.tensors(cs.exact(ft.block_bwd_plain, x, dy, w, a["heads"],
                                a["dh"]))
    assert cs.rel_max(port, jx) <= 1e-4
    assert cs.restated(cs.rel_max, cs.TRAIN_F32_MAX, cs.EXACT_K["fp32"],
                       jx, port, exact)[0]


def test_fault_3d_jax_per_block_route_against_the_trunk_kernel(actor_nets,
                                                              monkeypatch):
    """Fault 3d's oracle: the JAX per-block gradient route (interpret-mode
    fused_transformer_block x3, cls_final_block, the RMS final norm; jax.vjp)
    against the JAX whole-trunk backward `trunk_bwd_impl` in interpret
    mode, bf16, the trained actor's trunk at B=3 on 17 tokens (phase 13's
    case). On one platform the two routes take the same sums and agree
    within 2^-10 L per tensor (read 1.2e-4 L: the per-block route rounds dx
    to bf16 at each block's output), as the port's chain of plain versions
    equals `trunk_bwd_plain` bit for bit (read 0.0). On the card every sum
    of the port's chain takes another order (ROADMAP fault 3d)."""
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    a = cs.train_inputs(actor_nets["bfloat16"], 3,
                        np.random.default_rng(7))["actor"]
    x, dy = a["x"][:, :17].contiguous(), a["dy3"]
    blocks, fn, heads, dh = a["blocks"], a["fn"], a["heads"], a["dh"]
    jb = tuple(to_jax_flat(w) for w in blocks)
    jfn = tuple(jnp.asarray(t.numpy()).reshape(1, -1) for t in fn)
    jx, jdy = to_jax_flat([x])[0], to_jax_flat([dy])[0]

    def route(x, jb, jfn):
        for w in jb[:-1]:
            x = fused_transformer_block(x, w, heads, dh, True)
        c = cls_final_block(x, jb[-1], heads, dh, True)
        return _final_norm32(c.astype(jnp.float32), *jfn,
                             "rms").astype(x.dtype)

    _, vjp = jax.vjp(route, jx, jb, jfn)
    r = vjp(jdy)
    k = trunk_bwd_impl(jx, jdy, jb, jfn, heads=heads, dim_head=dh,
                       final_norm="rms", interpret=True)
    as_list = lambda res: [np.asarray(res[0], np.float32)] + [
        np.asarray(g, np.float32) for b in res[1] for g in b] + [
        np.asarray(res[2][0], np.float32)]
    worst = max(np.abs(p - q).max() / max(np.abs(q).max(), 1e-30)
                for p, q in zip(as_list(r), as_list(k)))
    assert worst <= 2.0 ** -10
    chain = cs.trunk_tensors(cs.trunk_chain_bwd(x, dy, blocks, fn, heads, dh,
                                                "rms"))
    plain = cs.trunk_tensors(trunk_bwd_plain(x, dy, blocks, fn, heads, dh,
                                             "rms"))
    assert all(torch.equal(c, p) for c, p in zip(chain, plain))


# (batch, n, pd, d, heads, dim_head, mlp, dtype, aligned, SMs) -> form
ROUTES = [
    ((1, 65, 320, 64, 4, 64, 2048, torch.bfloat16, True, 132), "cluster"),
    ((64, 65, 320, 64, 4, 64, 2048, torch.bfloat16, True, 132), "cluster"),
    ((90, 65, 320, 64, 4, 64, 2048, torch.bfloat16, True, 132), "cluster"),
    ((91, 65, 320, 64, 4, 64, 2048, torch.bfloat16, True, 132), "mma"),
    ((2048, 65, 320, 64, 4, 64, 2048, torch.bfloat16, True, 132), "mma"),
    ((11, 65, 320, 64, 4, 64, 2048, torch.bfloat16, True, 16), "cluster"),
    ((12, 65, 320, 64, 4, 64, 2048, torch.bfloat16, True, 16), "mma"),
    ((1, 80, 320, 64, 4, 64, 2048, torch.bfloat16, True, 132), "cluster"),
    ((1, 81, 320, 64, 4, 64, 2048, torch.bfloat16, True, 132), "fma"),
    ((1, 65, 320, 64, 4, 64, 2048, torch.float32, True, 132),
     "cluster_fp32"),
    ((1, 65, 320, 64, 4, 64, 2048, torch.bfloat16, False, 132), "fma"),
    ((1, 65, 320, 32, 4, 32, 2048, torch.bfloat16, True, 132), "fma"),
    ((1, 65, 320, 64, 2, 64, 2048, torch.bfloat16, True, 132), "mma"),
    ((1, 65, 320, 64, 4, 64, 192, torch.bfloat16, True, 132), "mma"),
    ((1, 65, 328, 64, 4, 64, 2048, torch.bfloat16, True, 132), "fma"),
    ((1, 17, 320, 64, 4, 64, 2048, torch.bfloat16, True, 132), "cluster"),
    ((1, 17, 1024, 64, 4, 64, 2048, torch.bfloat16, True, 132), "fma"),
    # fp32: the fp32 cluster form at the bf16 cluster's widths and bound
    # (pd a multiple of 8), else the FMA kernel
    ((16, 65, 320, 64, 4, 64, 2048, torch.float32, True, 132),
     "cluster_fp32"),
    ((90, 65, 320, 64, 4, 64, 2048, torch.float32, True, 132),
     "cluster_fp32"),
    ((91, 65, 320, 64, 4, 64, 2048, torch.float32, True, 132), "fma"),
    ((2048, 65, 320, 64, 4, 64, 2048, torch.float32, True, 132), "fma"),
    ((12, 65, 320, 64, 4, 64, 2048, torch.float32, True, 16), "fma"),
    ((1, 65, 320, 64, 4, 64, 2048, torch.float32, False, 132), "fma"),
    ((1, 65, 320, 32, 4, 32, 2048, torch.float32, True, 132), "fma"),
    ((1, 65, 320, 64, 3, 64, 2048, torch.float32, True, 132), "fma"),
    ((1, 65, 320, 64, 8, 64, 2048, torch.float32, True, 132), "fma"),
    ((1, 65, 320, 64, 4, 64, 192, torch.float32, True, 132), "fma"),
    ((1, 65, 324, 64, 4, 64, 2048, torch.float32, True, 132), "fma"),
    ((1, 81, 320, 64, 4, 64, 2048, torch.float32, True, 132), "fma"),
    ((1, 17, 320, 64, 4, 64, 2048, torch.float32, True, 132),
     "cluster_fp32"),
    ((1, 17, 4096, 64, 4, 64, 2048, torch.float32, True, 132), "fma"),
]


@pytest.mark.parametrize("args,form", ROUTES)
def test_k1_route_rule(args, form):
    """K1's form by batch and SM count (the cluster while 4 x batch <= 2.75
    x the SMs: at most 90 frames on an H100's 132), width, heads and MLP
    (4 heads, one a rank), dtype, alignment, token count (at most 80 rows)
    and patch width (a multiple of 16 whose staged pe_w fits the body; in
    fp32 a multiple of 8 whose pe_w slice fits under the CTA's layout)."""
    assert gm.k1_form_for(*args) == form


def test_fault_3f_fp32_trunk_backward_against_the_jax_kernel(actor_nets,
                                                            monkeypatch):
    """Fault 3f's oracle: the port's fp32 `trunk_bwd_plain` against the
    JAX `trunk_bwd_impl` in interpret mode, on the trained actor's trunk
    (its activations reach 1e4) at B=2 and 65 tokens, as phase 13 draws
    them. Both sum in fp32 in other orders, and each sits about as far
    from the port's float64-sum version as the other (read 6.1e-5 L the JAX
    kernel, 4.6e-5 L the port's plain version): the JAX kernel meets the
    restated fp32 check (max over the tensors of max|err|/L <= max(1e-3, 2
    x the port's plain version's own distance)), and the two agree within
    1e-3 L, phase 13's old limit (read 6.2e-5 L)."""
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    a = cs.train_inputs(actor_nets["float32"], 2,
                        np.random.default_rng(7))["actor"]
    args = (a["x"], a["dy3"], a["blocks"], a["fn"], a["heads"], a["dh"],
            "rms")
    port = cs.trunk_tensors(trunk_bwd_plain(*args))
    exact = cs.trunk_tensors(cs.exact(trunk_bwd_plain, *args))
    res = trunk_bwd_impl(
        jnp.asarray(args[0].numpy()), jnp.asarray(args[1].numpy()),
        tuple(to_jax_flat(w) for w in args[2]),
        tuple(jnp.asarray(t.numpy()).reshape(1, -1) for t in args[3]),
        heads=args[4], dim_head=args[5], final_norm="rms", interpret=True)
    flat_jax = [res[0], *[g for b in res[1] for g in b], res[2][0]]
    jx = [torch.from_numpy(np.array(t, np.float32)).reshape(p.shape)
          for t, p in zip(flat_jax, port)]
    assert len(jx) == len(port) == 1 + 11 * 4 + 1
    assert cs.rel_max(port, jx) <= cs.K6_F32_MAX
    assert cs.restated(cs.rel_max, cs.K6_F32_MAX, cs.EXACT_K["fp32"], jx,
                       port, exact)[0]


def test_fault_3i_composed_route_at_129_tokens_against_the_jax_kernel(
        monkeypatch):
    """Fault 3i's oracle: the JAX composed GoT route with its fused
    attention section (`_fused_attention_section`, the TPU kernel K7, in
    interpret mode) against the port's composed route with K7's plain
    version, at 129 tokens (8x20 patches of a 128x160 frame), flagship
    widths, depth 2, B=2, block dropout 0.1 (the route phase 17b's bf16
    gradient check takes on the card). fp32: latents within 2e-5 and every
    parameter gradient within rtol 1e-3 / atol 1e-4 (other summation
    orders); bf16: latents within 2^-5 L (both round after every operation,
    but PyTorch and XLA fuse different ones)."""
    from dgvit_tpu.models.got import GoT as JaxGoT
    from dgvit_tpu.ops import fused_block as jfb
    from dgvit_tpu_torch.models import layers
    from dgvit_tpu_torch.models.got import GoT
    from dgvit_tpu_torch.models.jax_io import params_from_jax, params_to_jax
    from dgvit_tpu_torch.ops import smem
    from dgvit_tpu_torch.ops.fused_block import fused_attention_section

    cfg = dict(image_size=(128, 160), patch_size=(8, 20), dim=D, depth=2,
               heads=4, dim_head=64, mlp_dim=2048, emb_dropout=0.0,
               dropout=0.1)
    rng = np.random.default_rng(129)
    jgot = JaxGoT(**cfg)
    shapes = jax.eval_shape(lambda: jgot.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 160)),
        jnp.zeros((1, D))))["params"]
    tree = jax.tree_util.tree_map(lambda s: (0.3 * rng.standard_normal(
        s.shape)).astype(np.float32), shapes)
    img = rng.uniform(0, 1, (2, 128, 160)).astype(np.float32)
    goal = rng.standard_normal((2, D)).astype(np.float32)
    cos = np.cos(np.arange(2 * D, dtype=np.float32)).reshape(2, D)
    # the JAX package takes its fused section on a TPU only: say it is
    # one, and run the kernel in interpret mode
    section = jfb.fused_attention_section
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfb, "fused_attention_section",
                        lambda *a: section(*a, True))
    monkeypatch.setattr(smem, "limit_for", lambda device: 232448)
    monkeypatch.setattr(layers, "_on_card", lambda t: True)
    seen = []
    monkeypatch.setattr(layers, "fused_attention_section",
                        lambda *a: seen.append(a[0].shape[1]) or
                        fused_attention_section(*a))

    def loss(p):
        return jnp.sum(jgot.apply({"params": p}, jnp.asarray(img),
                                  jnp.asarray(goal)) * jnp.asarray(cos))

    ref_p = jax.grad(loss)(tree)
    ref = np.asarray(jgot.apply({"params": tree}, jnp.asarray(img),
                                jnp.asarray(goal)))
    got = GoT(**cfg)
    got.load_state_dict(params_from_jax(tree))
    out = got(torch.from_numpy(img), torch.from_numpy(goal))
    (out * torch.from_numpy(cos)).sum().backward()
    assert seen == [129, 129]
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=2e-5,
                               atol=2e-5)
    mine = params_to_jax({n: p.grad for n, p in got.named_parameters()})
    grads = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v
             in jax.tree_util.tree_flatten_with_path(ref_p)[0]}
    assert mine.keys() == grads.keys()
    for key, r in grads.items():
        np.testing.assert_allclose(mine[key], r, rtol=1e-3, atol=1e-4,
                                   err_msg=key)
    jbf = JaxGoT(**cfg, dtype=jnp.bfloat16)
    ref16 = np.asarray(jbf.apply({"params": tree}, jnp.asarray(img),
                                 jnp.asarray(goal)).astype(jnp.float32))
    got16 = GoT(**cfg, dtype=torch.bfloat16)
    got16.load_state_dict(params_from_jax(tree))
    with torch.no_grad():
        out16 = got16(torch.from_numpy(img), torch.from_numpy(goal))
    assert out16.dtype == torch.bfloat16 and seen == [129] * 4
    assert np.abs(out16.float().numpy() - ref16).max() \
        <= 2.0 ** -5 * np.abs(ref16).max()
