"""The port's whole-trunk backward (K6,
dgvit_tpu_torch/ops/trunk_train.py) against the JAX package's
`trunk_bwd_impl` in Pallas interpret mode, and the port's trunk-gradient
GoT route against the JAX one, on the CPU.

On CPU tensors `trunk_bwd_fused` runs `trunk_bwd_plain`, the chain of the
hand-written block backwards that the CUDA kernel is held against on the
card. The small geometry is that of tests/test_trunk_train.py (dim 64, 2
heads x 16, (32, 40) frames in 16x20 patches: 5 tokens, or 3 for a
smaller image), with the MLP width of tests/torch_kernel_cases.py.

Tolerances: fp32 rtol 5e-4 / atol 5e-5 on dx, every block's 11 gradients
and the final norm's two (other summation orders, sums over every row,
through up to three blocks); bf16 as tests/torch_kernel_cases.py states,
pooled over all of a call's tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvit_tpu.models.got import GoT as JaxGoT
from dgvit_tpu.ops.trunk_train import _final_norm_bwd, trunk_bwd_impl
from dgvit_tpu_torch.models.got import GoT
from dgvit_tpu_torch.models.jax_io import params_from_jax, params_to_jax
from dgvit_tpu_torch.ops.got_megakernel import blocks_forward_plain
from dgvit_tpu_torch.ops.trunk_train import (final_norm_bwd_plain,
                                             tensor_core_trunk,
                                             trunk_bwd_fused,
                                             trunk_bwd_plain,
                                             trunk_streams_plain)
from dgvit_tpu_torch.ops.cls_block import cls_saved_width
from torch_kernel_cases import (D, DIM_HEAD, HEADS, MLP, assert_close,
                                bf16_close, block_tree, nudged_record, rand,
                                to_jax, to_torch, weights)

IMG, PATCH = (32, 40), (16, 20)


def trunk(rng, depth, final_norm, dtype):
    """(JAX blocks, JAX fn, port blocks, port fn) of `depth` seeded blocks."""
    pairs = [weights(block_tree(rng), dtype) for _ in range(depth)]
    s = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    if final_norm == "rms":
        b = np.zeros(D, np.float32)
    jfn = (jnp.asarray(s).reshape(1, -1), jnp.asarray(b).reshape(1, -1))
    return (tuple(p[0] for p in pairs), jfn, [p[1] for p in pairs],
            (torch.from_numpy(s), torch.from_numpy(b)))


def flat(result):
    """dx, every block's 11 grads and the final norm's, as one list. An
    all-zero bias gradient (RMS norm has no bias) is checked here and left
    out: the closeness checks scale by a tensor's largest |value|."""
    dx, gblocks, dfn = result
    dfn = [g for g in dfn if np.abs(np.asarray(g, np.float32)).max() > 0]
    return [dx, *[g for gb in gblocks for g in gb], *dfn]


# fp32 and bf16, rms and layer, an odd batch (padded to the TPU kernel's
# 8-frame tile on the JAX side), a smaller image (3 tokens), depth 3 (the
# reversed full-block loop runs twice)
CASES = [("float32", "rms", 4, 5, 3), ("bfloat16", "rms", 4, 5, 3),
         ("float32", "layer", 3, 5, 2), ("bfloat16", "layer", 3, 3, 2)]


def forward_streams(x, pb, pfn, final_norm):
    """The streams K4's plain forward writes for K6, as the trunk-gradient
    route hands them on."""
    return blocks_forward_plain(x, pb, pfn, HEADS, DIM_HEAD, final_norm,
                                streams=True)[1]


@pytest.mark.parametrize("dtype,final_norm,batch,n,depth", CASES)
def test_backward_matches_jax_trunk_kernel(dtype, final_norm, batch, n,
                                           depth):
    """K6 on the streams of K4's plain forward (what the route hands it)
    against the JAX kernel, which recomputes them."""
    rng = np.random.default_rng(batch * 100 + n * 10 + depth)
    jb, jfn, pb, pfn = trunk(rng, depth, final_norm, dtype)
    x, dy = rand(rng, batch, n, D), rand(rng, batch, D)
    ref = trunk_bwd_impl(to_jax(x, dtype), to_jax(dy, dtype), jb, jfn,
                         heads=HEADS, dim_head=DIM_HEAD,
                         final_norm=final_norm, interpret=True)
    trunk_bwd_fused.launches = 0
    xt = to_torch(x, dtype)
    out = trunk_bwd_fused(xt, to_torch(dy, dtype), pb, pfn, HEADS, DIM_HEAD,
                          final_norm, forward_streams(xt, pb, pfn,
                                                      final_norm))
    assert trunk_bwd_fused.launches == 0
    dx, gblocks, dfn = out
    assert dx.shape == x.shape and dx.dtype == getattr(torch, dtype)
    assert all(g.shape == t.shape and g.dtype == t.dtype
               for gb, w in zip(gblocks, pb) for g, t in zip(gb, w))
    assert all(g.shape == (D,) and g.dtype == torch.float32 for g in dfn)
    assert_close(flat(out), flat(ref), dtype, 5e-4, 5e-5)


@pytest.mark.parametrize("dtype,final_norm,batch,n,depth", CASES)
def test_forward_streams_are_the_recomputed_ones(dtype, final_norm, batch,
                                                 n, depth):
    """The streams K4's plain forward returns are, bit for bit, those the
    plain backward recomputes without them, and the backward on either is
    the same."""
    rng = np.random.default_rng(batch * 100 + n * 10 + depth)
    _, _, pb, pfn = trunk(rng, depth, final_norm, dtype)
    x = to_torch(rand(rng, batch, n, D), dtype)
    dy = to_torch(rand(rng, batch, D), dtype)
    xs, cls, saved = forward_streams(x, pb, pfn, final_norm)
    rxs, rcls, rsaved = trunk_streams_plain(x, pb, HEADS, DIM_HEAD)
    assert xs.shape == (depth - 1, batch, n, D) and cls.shape == (batch, D)
    assert xs.dtype == cls.dtype == x.dtype
    assert saved.shape == (batch, cls_saved_width(n, D, HEADS, DIM_HEAD,
                                                  MLP))
    assert saved.dtype == torch.float32
    assert torch.equal(xs, rxs) and torch.equal(cls, rcls)
    assert torch.equal(saved, rsaved)
    given = flat(trunk_bwd_plain(x, dy, pb, pfn, HEADS, DIM_HEAD, final_norm,
                                 (xs, cls, saved)))
    recomputed = flat(trunk_bwd_plain(x, dy, pb, pfn, HEADS, DIM_HEAD,
                                      final_norm))
    assert all(torch.equal(a, b) for a, b in zip(given, recomputed))


@pytest.mark.parametrize("dtype,final_norm,batch,n,depth", CASES)
def test_backward_recomputes_without_streams(dtype, final_norm, batch, n,
                                             depth):
    """Without streams the plain version recomputes them, as the JAX
    kernel does, and meets the JAX kernel at the same tolerance."""
    rng = np.random.default_rng(batch * 100 + n * 10 + depth)
    jb, jfn, pb, pfn = trunk(rng, depth, final_norm, dtype)
    x, dy = rand(rng, batch, n, D), rand(rng, batch, D)
    ref = trunk_bwd_impl(to_jax(x, dtype), to_jax(dy, dtype), jb, jfn,
                         heads=HEADS, dim_head=DIM_HEAD,
                         final_norm=final_norm, interpret=True)
    out = trunk_bwd_fused(to_torch(x, dtype), to_torch(dy, dtype), pb, pfn,
                          HEADS, DIM_HEAD, final_norm)
    assert_close(flat(out), flat(ref), dtype, 5e-4, 5e-5)


def next_bf16(t: torch.Tensor, index) -> torch.Tensor:
    """A copy of bf16 t with the value at `index` one ulp further from
    zero."""
    t = t.clone()
    bits = t.view(torch.int16)
    bits[index] += 1
    return t


@pytest.mark.parametrize("which", ["block input", "cls row", "cls record"])
def test_backward_differentiates_the_streams_it_is_given(which):
    """Faults j and k: K6 must differentiate the streams the forward
    wrote, not streams it recomputes. A stream moved by one bf16 ulp (one
    value of a block's input; the CLS row of one frame, whose single-value
    nudges the rounding of dcls can absorb; the CLS block's saved o of one
    frame) moves dx: the backward reads the stream. The same call without
    streams returns the gradient of the unmoved ones."""
    rng = np.random.default_rng(11)
    _, _, pb, pfn = trunk(rng, 3, "layer", "bfloat16")
    x = to_torch(rand(rng, 2, 5, D), "bfloat16")
    dy = to_torch(rand(rng, 2, D), "bfloat16")
    xs, cls, saved = forward_streams(x, pb, pfn, "layer")
    if which == "block input":
        xs = next_bf16(xs, (1, 0, 2, 5))     # block 2's input, frame 0
    elif which == "cls row":
        cls = next_bf16(cls, 1)              # frame 1's CLS row
    else:
        saved = nudged_record(saved, 0, "q", 3, 5)    # frame 0's q
    args = (x, dy, pb, pfn, HEADS, DIM_HEAD, "layer")
    moved = trunk_bwd_fused(*args, (xs, cls, saved))
    kept = trunk_bwd_fused(*args)
    assert not torch.equal(moved[0], kept[0])
    assert torch.equal(kept[0], trunk_bwd_plain(*args, forward_streams(
        x, pb, pfn, "layer"))[0])
    assert all(bool(torch.isfinite(t.float()).all()) for t in flat(moved))


def test_wrapper_rejects_streams_of_the_wrong_shape():
    rng = np.random.default_rng(6)
    _, _, pb, pfn = trunk(rng, 3, "rms", "float32")
    x, dy = torch.zeros(2, 5, D), torch.zeros(2, D)
    xs, cls = torch.zeros(2, 2, 5, D), torch.zeros(2, D)
    saved = torch.zeros(2, cls_saved_width(5, D, HEADS, DIM_HEAD, MLP))
    with pytest.raises(ValueError, match="stream"):
        trunk_bwd_fused(x, dy, pb, pfn, HEADS, DIM_HEAD, "rms",
                        (xs[:1].contiguous(), cls, saved))
    with pytest.raises(ValueError, match="stream"):
        trunk_bwd_fused(x, dy, pb, pfn, HEADS, DIM_HEAD, "rms",
                        (xs, cls.bfloat16(), saved))
    with pytest.raises(ValueError, match="stream"):
        trunk_bwd_fused(x, dy, pb, pfn, HEADS, DIM_HEAD, "rms",
                        (xs.transpose(2, 3).contiguous().transpose(2, 3),
                         cls, saved))
    with pytest.raises(ValueError, match="CLS record"):
        trunk_bwd_fused(x, dy, pb, pfn, HEADS, DIM_HEAD, "rms",
                        (xs, cls, saved[:, 1:].contiguous()))


@pytest.mark.parametrize("final_norm", ["rms", "layer"])
def test_final_norm_backward_matches_jax(final_norm):
    rng = np.random.default_rng(3)
    dy, cls = rand(rng, 5, D), rand(rng, 5, D)
    s = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    ref = _final_norm_bwd(jnp.asarray(dy), jnp.asarray(cls),
                          jnp.asarray(s)[None], jnp.asarray(b)[None],
                          final_norm)
    out = final_norm_bwd_plain(torch.from_numpy(dy), torch.from_numpy(cls),
                               torch.from_numpy(s), torch.from_numpy(b),
                               final_norm)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r).reshape(o.shape),
                                   rtol=1e-5, atol=1e-6)


def test_plain_backward_is_the_gradient_of_the_forward():
    """fp32: the hand-written chain is autograd of K4's plain forward."""
    rng = np.random.default_rng(4)
    _, _, pb, pfn = trunk(rng, 3, "layer", "float32")
    x, dy = to_torch(rand(rng, 3, 5, D), "float32"), to_torch(
        rand(rng, 3, D), "float32")
    xr = x.clone().requires_grad_()
    wr = [[t.clone().requires_grad_() for t in w] for w in pb]
    fr = [t.clone().requires_grad_() for t in pfn]
    y = blocks_forward_plain(xr, wr, fr, HEADS, DIM_HEAD, "layer")
    leaves = [xr, *[t for w in wr for t in w], *fr]
    ref = torch.autograd.grad(y, leaves, dy)
    out = flat(trunk_bwd_plain(x, dy, pb, pfn, HEADS, DIM_HEAD, "layer"))
    assert_close(out, ref, "float32", 5e-4, 5e-5)


def test_bf16_catches_autograd_backward():
    """The rounding points are the contract: autograd of the plain forward
    rounds where the forward casts, not where the TPU backward does, and
    fails the bf16 check that the hand-placed chain passes."""
    rng = np.random.default_rng(4 * 100 + 5 * 10 + 3)
    jb, jfn, pb, pfn = trunk(rng, 3, "layer", "bfloat16")
    x, dy = rand(rng, 4, 5, D), rand(rng, 4, D)
    ref = flat(trunk_bwd_impl(to_jax(x, "bfloat16"), to_jax(dy, "bfloat16"),
                              jb, jfn, heads=HEADS, dim_head=DIM_HEAD,
                              final_norm="layer", interpret=True))
    args = (to_torch(x, "bfloat16"), to_torch(dy, "bfloat16"), pb, pfn,
            HEADS, DIM_HEAD, "layer")
    assert bf16_close(flat(trunk_bwd_plain(*args)), ref)
    xr = args[0].clone().requires_grad_()
    wr = [[t.clone().requires_grad_() for t in w] for w in pb]
    fr = [t.clone().requires_grad_() for t in pfn]
    y = blocks_forward_plain(xr, wr, fr, HEADS, DIM_HEAD, "layer")
    wrong = torch.autograd.grad(y, [xr, *[t for w in wr for t in w], *fr],
                                args[1])
    assert not bf16_close(wrong, ref)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(5)
    _, _, pb, pfn = trunk(rng, 2, "rms", "float32")
    x, dy = torch.zeros(2, 5, D), torch.zeros(2, D)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        trunk_bwd_fused(x.half(), dy.half(), pb, pfn, HEADS, DIM_HEAD, "rms")
    with pytest.raises(ValueError, match="shape"):
        trunk_bwd_fused(x, torch.zeros(2, 5, D), pb, pfn, HEADS, DIM_HEAD,
                        "rms")
    with pytest.raises(TypeError):
        trunk_bwd_fused(x, dy, pb, tuple(t.double() for t in pfn), HEADS,
                        DIM_HEAD, "rms")
    with pytest.raises(ValueError, match="final_norm"):
        trunk_bwd_fused(x, dy, pb, pfn, HEADS, DIM_HEAD, "batch")
    with pytest.raises(ValueError, match="contiguous"):
        trunk_bwd_fused(torch.zeros(2, D, 5).transpose(1, 2), dy, pb, pfn,
                        HEADS, DIM_HEAD, "rms")


# (depth, the block and weight made unaligned or None, tensor cores):
# wqkv, wout, w1 and w2 must be 16-byte aligned in every block, the last
# (CLS) block's too
TRUNK_ROUTES = [(4, None, True), (1, None, True), (4, (3, 7), False),
                (4, (3, 2), False), (4, (0, 9), False)]


@pytest.mark.parametrize("depth,unaligned,mma", TRUNK_ROUTES)
def test_tensor_core_route_takes_every_block(depth, unaligned, mma):
    """K6 takes the bf16 tensor-core bodies at the flagship widths only
    where every block's matrix weights are 16-byte aligned, the CLS
    block's included, as its launch checks them."""
    inner, dt = 256, torch.bfloat16
    shapes = [(64,), (64,), (64, 3 * inner), (inner, 64), (64,), (64,),
              (64,), (64, 2048), (2048,), (2048, 64), (64,)]
    blocks = [[torch.zeros(s, dtype=dt) for s in shapes]
              for _ in range(depth)]
    if unaligned is not None:
        i, j = unaligned
        t = blocks[i][j]
        blocks[i][j] = torch.zeros(t.numel() + 1, dtype=dt)[1:].view_as(t)
    x = torch.zeros(2, 65, 64, dtype=dt)
    assert tensor_core_trunk(x, blocks, 64) is mma


def got_pair(final_norm, depth, hw, seed):
    """The JAX GoT, its numpy-seeded parameters, the port's GoT carrying
    them with the trunk-gradient route on, and seeded inputs."""
    cfg = dict(image_size=IMG, patch_size=PATCH, dim=D, depth=depth,
               heads=HEADS, dim_head=DIM_HEAD, mlp_dim=MLP,
               final_norm=final_norm, emb_dropout=0.0)
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (4, *hw)).astype(np.float32)
    goal = rng.standard_normal((4, D)).astype(np.float32)
    jgot = JaxGoT(**cfg)
    shapes = jax.eval_shape(lambda: jgot.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *IMG)), jnp.zeros((1, D))))
    tree = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes["params"])
    got = GoT(**cfg, trunk_grad=True)
    got.load_state_dict(params_from_jax(tree))
    return jgot, tree, got, img, goal


@pytest.mark.parametrize("final_norm,depth,hw", [("rms", 3, IMG),
                                                 ("layer", 2, (16, 40))])
def test_got_trunk_grad_route_matches_jax(final_norm, depth, hw,
                                          monkeypatch):
    """Full parameter and goal gradients of the port's GoT on the
    trunk-gradient route (K4 forward, K6 backward: the plain versions
    here) against the JAX GoT with DGVIT_TRUNK_GRAD=1 and its kernels in
    interpret mode; fp32, rtol 1e-3 / atol 1e-4 (as the JAX package's own
    gate, tests/test_trunk_train.py, through the embedding as well)."""
    jgot, tree, got, img, goal = got_pair(final_norm, depth, hw, 21)
    cos = np.cos(np.arange(4 * D, dtype=np.float32)).reshape(4, D)
    monkeypatch.setenv("DGVIT_FUSED_INTERPRET", "1")
    monkeypatch.setenv("DGVIT_TRUNK_GRAD", "1")

    def loss(p, g):
        return jnp.sum(jgot.apply({"params": p}, jnp.asarray(img), g)
                       * jnp.asarray(cos))

    ref_p, ref_g = jax.grad(loss, argnums=(0, 1))(tree, jnp.asarray(goal))
    g = torch.from_numpy(goal).requires_grad_()
    out = got(torch.from_numpy(img), g)
    assert out.grad_fn is not None and out.grad_fn.name().startswith(
        "_BlocksCls")
    (out * torch.from_numpy(cos)).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(ref_g), rtol=1e-3,
                               atol=1e-4)
    mine = params_to_jax({n: p.grad for n, p in got.named_parameters()})
    ref = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
           jax.tree_util.tree_flatten_with_path(ref_p)[0]}
    assert mine.keys() == ref.keys()
    for key, r in ref.items():
        np.testing.assert_allclose(mine[key], r, rtol=1e-3, atol=1e-4,
                                   err_msg=key)
