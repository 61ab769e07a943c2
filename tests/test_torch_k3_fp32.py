"""K3f's and K3b's fp32 cluster forms (dgvit_tpu_torch/ops/csrc/block_grad.cu:
cls_attend_cluster_fp32_kernel and cls_bwd_cluster_fp32_kernel, one frame
over a cluster of 4 CTAs on tf32_block.cuh's body, with the batched
CLS-row MLP launches cls_mlp_fp32_kernel and cls_mlp_bwd_fp32_kernel), and
the rule that a backward runs the form its forward ran, on the CPU.

The kernels run only on the card (chip_smoke.py phases 5, 13b, 22a and 23a
hold them there). Here: the rule that picks them (`block_form` with cls,
form 2) and the form each launch passes; that a backward under autograd
takes its forward's form, a dy off a 16-byte boundary copied, and that
K3b refuses records another form wrote; the shared-memory mirror of the
new layouts; and that CPU tensors at the widths the forms take go to the
plain versions, held against the JAX package's `cls_final_block` (its
Pallas kernel in interpret mode, `jax.vjp` for the backward) at d =
dim_head = 64, 4 heads, 65 tokens, MLP 256, B = 2. Tolerances as
tests/test_torch_block_grad.py states them for fp32: 2e-5 on the forward,
rtol 5e-4 / atol 5e-5 on dx and the 11 weight gradients.
"""

import jax
import numpy as np
import pytest
import torch

from dgvit_tpu.ops.cls_block import cls_final_block as jcls
from dgvit_tpu_torch.ops import cls_block as cb
from dgvit_tpu_torch.ops import fused_transformer as ft
from dgvit_tpu_torch.ops import smem
from torch_kernel_cases import (assert_close, block_tree, rand, to_jax,
                                to_torch, weights)

FP32, BF16 = torch.float32, torch.bfloat16
H100 = 232448          # shared memory a block may opt into on an H100
H100_SM = 233472       # shared memory of an H100 SM (228 KB)
D, HEADS, DIM_HEAD, MLP, N, BATCH = 64, 4, 64, 256, 65, 2


def block_weights(d, heads, dim_head, mlp, dtype, shift=None):
    """Seeded weights of one block as the kernels take them; `shift`
    names a matrix moved one element off a 16-byte boundary."""
    gen = torch.Generator().manual_seed(5)
    inner = heads * dim_head
    shapes = [(d,), (d,), (d, 3 * inner), (inner, d), (d,), (d,), (d,),
              (d, mlp), (mlp,), (mlp, d), (d,)]
    w = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    if shift is not None:
        i = {"wqkv": 2, "wout": 3, "w1": 7, "w2": 9}[shift]
        w[i] = torch.zeros(w[i].numel() + 1, dtype=dtype)[1:].view(
            w[i].shape)
    return w


def off_boundary(*shape, dtype=FP32):
    """A zero tensor one element past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(*shape)


# (case, dtype, tokens, d, heads, dim_head, mlp, what is off a 16-byte
# boundary, the form K3f and K3b take)
ROUTES = [
    ("cluster widths", FP32, 65, 64, 4, 64, 2048, None, 2),
    ("80 rows", FP32, 80, 64, 4, 64, 2048, None, 2),
    ("mlp 256", FP32, 65, 64, 4, 64, 256, None, 2),
    ("d = 32", FP32, 65, 32, 4, 32, 2048, None, 0),
    ("8 heads", FP32, 65, 64, 8, 64, 2048, None, 0),
    ("81 rows", FP32, 81, 64, 4, 64, 2048, None, 0),
    ("mlp 192", FP32, 65, 64, 4, 64, 192, None, 0),
    ("wqkv off", FP32, 65, 64, 4, 64, 2048, "wqkv", 0),
    ("w2 off", FP32, 65, 64, 4, 64, 2048, "w2", 0),
    ("bf16", BF16, 65, 64, 4, 64, 2048, None, 1),
]


@pytest.mark.parametrize("case,dtype,n,d,heads,dim_head,mlp,shift,form",
                         ROUTES, ids=[r[0] for r in ROUTES])
def test_route_rule(case, dtype, n, d, heads, dim_head, mlp, shift, form,
                    monkeypatch):
    """fp32 K3 takes its cluster form (2) at the full block's cluster
    widths (fp32, d = dim_head = 64, 4 heads, at most 80 tokens, mlp a
    multiple of 256, aligned operands), the FMA body (0) off them; bf16
    keeps the tensor-core body (1). The launches pass the form, K3f keeps
    it on its records, K3f's cluster form takes a (B, d) fp32 scratch
    row; the launches are recorded here, not made."""
    w = block_weights(d, heads, dim_head, mlp, dtype, shift)
    x = torch.zeros(2, n, d, dtype=dtype)
    dy = torch.zeros(2, d, dtype=dtype)
    assert ft.block_form(x, w, dim_head, True) == form
    assert ft.block_form(x, w, dim_head, True, dy) == form
    launched = []
    monkeypatch.setattr(ft, "_block_lib", lambda: type("Lib", (), {
        "block_forward_launch": None, "block_backward_launch": None,
        "block_backward_workspace": staticmethod(lambda *a: 16)})())
    monkeypatch.setattr(ft, "_call", lambda fn, dt, c, tensors, x, heads,
                        dim_head, mlp, f: launched.append((c, f, tensors)))
    rec = cb.saved_buffer(x, w, heads, dim_head)
    ft.launch_block_fwd(x, w, heads, dim_head, True, saved=rec)
    ft.launch_block_bwd(x, dy, w, heads, dim_head, True, saved=rec)
    assert [(c, f) for c, f, _ in launched] == [(True, form), (True, form)]
    assert rec.form == form
    work = launched[0][2][-1]
    assert (work is None) == (form != 2)
    if form == 2:
        assert work.shape == (2, d) and work.dtype == FP32


def test_misaligned_dy_takes_the_fma_body_only_when_called_directly():
    """A direct call keeps the rule: a dy off a 16-byte boundary takes
    the FMA body (form 0); `aligned_for` copies such a dy for a form that
    needs it, and leaves an aligned dy or the FMA body's alone."""
    w = block_weights(D, HEADS, DIM_HEAD, 2048, FP32)
    x = torch.zeros(2, N, D)
    dy = off_boundary(2, D)
    assert dy.data_ptr() % 16 and ft.block_form(x, w, DIM_HEAD, True) == 2
    assert ft.block_form(x, w, DIM_HEAD, True, dy) == 0
    fresh = ft.aligned_for(dy, 2)
    assert fresh.data_ptr() % 16 == 0 and torch.equal(fresh, dy)
    assert ft.aligned_for(dy, 0) is dy
    aligned = torch.zeros(2, D)
    assert ft.aligned_for(aligned, 2) is aligned


def cpu_block(rng, mlp=MLP, heads=HEADS, dim_head=DIM_HEAD):
    tree = block_tree(rng, heads=heads, dim_head=dim_head, mlp=mlp)
    return tree, weights(tree, "float32")


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_backward_takes_the_forward_form(kernel, monkeypatch):
    """Gap u on CPU tensors: under autograd K2b and K3b run the form their
    forward took, here the fp32 cluster form, although the upstream
    gradient lies one element off a 16-byte boundary (the rule would give
    the FMA body); the backward gets that gradient copied to a fresh,
    aligned tensor. The wrappers' forms are recorded, the plain versions
    run."""
    rng = np.random.default_rng(4)
    _, (_, w) = cpu_block(rng)
    x = to_torch(rand(rng, BATCH, N, D), "float32").requires_grad_()
    seen = []
    if kernel == "K2":
        mod, fwd_name, bwd_name = ft, "block_fwd_fused", "block_bwd_fused"
        run = lambda: ft.fused_transformer_block(x, w, HEADS, DIM_HEAD)
        shape = (BATCH, N, D)
    else:
        mod, fwd_name, bwd_name = cb, "cls_fwd_fused", "cls_bwd_fused"
        run = lambda: cb.cls_final_block(x, w, HEADS, DIM_HEAD)
        shape = (BATCH, D)
    fwd, bwd = getattr(mod, fwd_name), getattr(mod, bwd_name)

    def fwd_spy(*args, form=None, **kw):
        seen.append(("forward", form))
        return fwd(*args, form=form, **kw)

    def bwd_spy(x, dy, *args, form=None):
        seen.append(("backward", form, dy.data_ptr() % 16))
        return bwd(x, dy, *args, form=form)
    monkeypatch.setattr(mod, fwd_name, fwd_spy)
    monkeypatch.setattr(mod, bwd_name, bwd_spy)
    out = run()
    g = off_boundary(*shape)
    g.copy_(torch.from_numpy(rand(rng, *shape)))
    assert ft.block_form(x.detach(), w, DIM_HEAD, kernel == "K3", g) == 0
    out.backward(g)
    assert seen == [("forward", 2), ("backward", 2, 0)]
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_k3b_refuses_records_of_another_form():
    """K3b on records that K3f wrote in another form raises, naming both
    forms: at the wrapper (either device) and at the launch, before any
    library is loaded; the same form passes the check."""
    rng = np.random.default_rng(6)
    _, (_, w) = cpu_block(rng)
    x = to_torch(rand(rng, BATCH, N, D), "float32")
    dy = to_torch(rand(rng, BATCH, D), "float32")
    _, rec = cb.cls_fwd_plain(x, w, HEADS, DIM_HEAD, save=True)
    rec.form = 2
    with pytest.raises(ValueError, match="form 0 .* form 2"):
        cb.cls_bwd_fused(x, dy, w, HEADS, DIM_HEAD, rec, form=0)
    with pytest.raises(ValueError, match="form 0 .* form 2"):
        ft.launch_block_bwd(x, dy, w, HEADS, DIM_HEAD, True, saved=rec,
                            form=0)
    dx, _ = cb.cls_bwd_fused(x, dy, w, HEADS, DIM_HEAD, rec, form=2)
    ref, _ = cb.cls_bwd_plain(x, dy, w, HEADS, DIM_HEAD, rec)
    assert torch.equal(dx, ref)


@pytest.mark.parametrize("n", [65, 80])
def test_layouts(n):
    """The mirrors against the layouts written out (block_grad.cu):
    K3f's attention launch holds the head's fp32 k (rows of 72) and v
    (rows of 68) and its q|k|v and wout slices (64 x 68 each), the
    out-projection's partial over the q|k|v slices: 114,432 bytes, so two
    CTAs fit an SM's 228 KB (1 KB of each reserved); K3b's per-frame
    launch lays dh1's partial tile (16 x 64 a warp) over k, the column
    sums by warp over v and row 0's ds, p (rows of 80), do and q over the
    wout slice: the same bytes; the batched CLS-row MLP launches hold four
    warps' w1 and w2 chunks (64 x 68 each): 139,264 bytes. Rows pad to 80,
    so the counts hold at 65 and 80 rows, all under an H100's opt-in."""
    np_, w64 = 80, 4 * 64 * 68
    attn = 4 * np_ * 72 + 4 * np_ * 68 + 4 * w64
    assert smem.cls_attend_fp32(n) == attn == 114432
    assert 2 * (attn + 1024) <= H100_SM
    assert 4 * np_ * 64 <= 4 * np_ * 72 and 4 * (np_ // 16) * 64 <= 4 * np_ * 68
    assert 2 * 4 * np_ + 2 * 4 * 64 <= w64
    assert smem.cls_bwd_cluster_fp32(n) == attn
    assert smem.CLS_MLP_FP32 == 4 * 2 * w64 == 139264 <= H100
    flag = (64, 4, 64, 2048, FP32)
    assert smem.bytes_needed("K3f", n, *flag) == max(
        smem.fwd_fma(n, *flag), 139264)
    assert smem.bytes_needed("K3b", n, *flag) == max(
        smem.bwd_fma(n, 64, 2048), 139264)
    # past 80 rows neither form is taken: the FMA bodies' bytes
    assert smem.bytes_needed("K3b", 81, *flag) == smem.bwd_fma(81, 64, 2048)
    assert smem.bytes_needed("K3f", 81, *flag) == smem.fwd_fma(81, *flag)


def test_cpu_tensors_take_the_plain_versions():
    """At the widths the cluster forms take, CPU tensors run
    cls_fwd_plain and cls_bwd_plain through `cls_final_block` (no launch,
    no cluster launch), and those match the JAX package's
    `cls_final_block` forward and VJP (interpret mode) at d = dim_head =
    64, 4 heads, 65 tokens, MLP 256, B = 2, fp32."""
    rng = np.random.default_rng(23)
    tree, (flat, w) = cpu_block(rng)
    x, dy = rand(rng, BATCH, N, D), rand(rng, BATCH, D)
    xt, dyt = to_torch(x, "float32"), to_torch(dy, "float32")
    assert ft.block_form(xt, w, DIM_HEAD, True, dyt) == 2
    y_ref, vjp = jax.vjp(lambda x, fl: jcls(x, fl, HEADS, DIM_HEAD, True),
                         to_jax(x, "float32"), flat)
    dx_ref, dflat = vjp(to_jax(dy, "float32"))
    for fn in (cb.cls_fwd_fused, cb.cls_bwd_fused):
        fn.launches = fn.cluster_launches = 0
    xg = xt.clone().requires_grad_()
    wg = [t.clone().requires_grad_() for t in w]
    y = cb.cls_final_block(xg, wg, HEADS, DIM_HEAD)
    y.backward(dyt)
    for fn in (cb.cls_fwd_fused, cb.cls_bwd_fused):
        assert fn.launches == fn.cluster_launches == 0
    assert y.shape == (BATCH, D) and y.dtype == FP32
    grads = [t.grad for t in wg]
    assert all(g.shape == t.shape and g.dtype == FP32
               for g, t in zip(grads, w))
    assert_close([y], [y_ref], "float32", 2e-5, 2e-5)
    assert_close([xg.grad, *grads], [dx_ref, *dflat], "float32", 5e-4, 5e-5)
    # the plain versions are what the wrappers run
    out, rec = cb.cls_fwd_fused(xt, w, HEADS, DIM_HEAD, save=True)
    pout, prec = cb.cls_fwd_plain(xt, w, HEADS, DIM_HEAD, save=True)
    assert torch.equal(out, pout) and torch.equal(rec, prec)
    dx, g2 = cb.cls_bwd_fused(xt, dyt, w, HEADS, DIM_HEAD, rec, form=2)
    pdx, pgrads = cb.cls_bwd_plain(xt, dyt, w, HEADS, DIM_HEAD, rec)
    assert torch.equal(dx, pdx) and all(
        torch.equal(a, b) for a, b in zip(g2, pgrads))
    for fn in (cb.cls_fwd_fused, cb.cls_bwd_fused):
        assert fn.launches == fn.cluster_launches == 0
