"""The port's shared-memory mirror and route rule (dgvit_tpu_torch/ops/
smem.py) on the CPU.

A kernel of the port keeps a frame in one thread block's shared memory,
so the model's routes send a frame the kernels cannot hold to the
composed blocks. The mirror repeats the CUDA sources' layouts; the byte
counts pinned here were read from the libraries' own queries on an H100
(chip_smoke.py phase 17b holds every count against them). The route tests
give the rule the H100's per-block limit (232,448 bytes) on CPU tensors,
where the kernel wrappers run their plain versions, and record which
entry point each call of the model reaches.
"""

import numpy as np
import pytest
import torch

from dgvit_tpu_torch.models import got as got_mod
from dgvit_tpu_torch.models import layers
from dgvit_tpu_torch.models.got import GoT
from dgvit_tpu_torch.ops import smem

H100 = 232448          # shared memory a block may opt into on an H100
FLAGSHIP = (64, 4, 64, 2048)   # d, heads, dim_head, mlp
BF16, FP32 = torch.bfloat16, torch.float32

# bytes at the flagship widths (read from the libraries on an H100 for the
# forward kernels, and from the formulas of block_common.cuh, block_grad.cu
# and attention.cu). K6 runs no forward (it reads K4's streams), so it
# sizes by its largest backward body, as K2b and K3b do. In fp32 up to 80
# rows K2b may take its cluster form (a CTA of bw32::Layout, 225,792
# bytes), K2f its own (cl32::Layout, under the FMA body's 168,752), K3b
# its own (the batched CLS-row MLP launch's 139,264 over the FMA body's
# 136,240; the per-frame launch's ClsBwdLayout 114,432) and K3f its own
# (under the FMA body's).
BYTES = {
    (BF16, 65): {"K1": 142080, "K4": 142080, "K2b": 215056, "K3b": 136240,
                 "K6": 215056, "K7": 115712},
    (BF16, 90): {"K1": 141488, "K4": 141488, "K2b": 188640, "K3b": 188640,
                 "K6": 188640, "K7": 27168},
    (BF16, 129): {"K1": 202800, "K4": 202800, "K2b": 271440, "K3b": 271440,
                  "K6": 271440, "K7": 38720},
    (BF16, 256): {"K1": 402432, "K4": 402432, "K2b": 798720, "K3b": 798720,
                  "K6": 798720, "K7": 76288},
    (FP32, 65): {"K1": 168752, "K4": 168752, "K2b": 225792, "K3b": 139264,
                 "K6": 136240, "K7": 36672},
    (FP32, 90): {"K1": 233648, "K4": 233648, "K2b": 188640, "K3b": 188640,
                 "K6": 188640, "K7": 50464},
    (FP32, 129): {"K1": 334896, "K4": 334896, "K2b": 271440, "K3b": 271440,
                  "K6": 271440, "K7": 72000},
    (FP32, 256): {"K1": 664576, "K4": 664576, "K2b": 798720, "K3b": 798720,
                  "K6": 798720, "K7": 142080},
}


@pytest.mark.parametrize("dtype,n", list(BYTES),
                         ids=[f"{'bf16' if d == BF16 else 'fp32'}-{n}"
                              for d, n in BYTES])
def test_mirror_bytes(dtype, n):
    for kernel, want in BYTES[(dtype, n)].items():
        assert smem.bytes_needed(kernel, n, *FLAGSHIP, dtype) == want, kernel
    # K2f and K3f size like K4 (the same bodies: the tensor-core one up to
    # 80 rows in bf16, else the FMA one, as K1 past 80 rows and in fp32)
    assert smem.bytes_needed("K2f", n, *FLAGSHIP, dtype) == \
        smem.bytes_needed("K3f", n, *FLAGSHIP, dtype) == \
        BYTES[(dtype, n)]["K4"]
    assert smem.fwd_fma(n, *FLAGSHIP, dtype) == \
        (102192 if (dtype, n) == (BF16, 65) else BYTES[(dtype, n)]["K1"])


def test_mirror_layouts():
    """The tensor-core layouts: the forward body's 142,080 bytes at 65
    rows (two frames a block), K2b's 215,056, K3b's 128,560 (under the
    FMA body's 136,240, so K3b's and K6's counts at 65 tokens stay the FMA
    body's and K2b's); rows pad to 16, and each 16 more rows add two
    frames' q, k and v tiles."""
    assert smem.fwd_mma(65) == smem.fwd_mma(80) == 142080
    assert smem.bwd_mma(65) == 215056
    assert smem.bwd_cls_mma(65, 4, 64, 2048) == 128560
    assert smem.bwd_cls_mma(80, 4, 64, 2048) == 136464 <= H100
    # where the CLS body is the larger, K3b and K6 size by it
    assert smem.bytes_needed("K3b", 17, *FLAGSHIP, BF16) == \
        smem.bwd_cls_mma(17, 4, 64, 2048) > smem.bwd_fma(17, 64, 2048)
    assert smem.bytes_needed("K3b", 17, *FLAGSHIP, FP32) == max(
        smem.bwd_fma(17, 64, 2048), smem.cls_bwd_cluster_fp32(17),
        smem.CLS_MLP_FP32)
    assert smem.fwd_mma(96) == smem.fwd_mma(80) + 3 * 2 * 16 * 72 * 2
    assert smem.bwd_mma(80) == 226816 <= H100
    # K7 takes the fewest query tiles that fit: one row always fits here
    assert smem.section(256, 64, 64, 256, FP32) > H100 \
        >= smem.section(256, 64, 64, 1, FP32)


@pytest.mark.parametrize("n,section", [(65, 115712), (80, 115712),
                                       (17, 88064), (1, 78848)])
def test_k7_tensor_core_layout(n, section):
    """K7's tensor-core form: two frames' k and v of one head (rows padded
    to 16, 72 bf16 values a row) and two heads' wqkv (64 x 200) and wout
    (64 x 72) slices; under the forward body's bytes, so K7's route at 80
    rows and fewer asks for the larger of it and the FMA kernel's one-row
    tile."""
    np_ = (n + 15) // 16 * 16
    assert smem.section_mma(n) == section == (
        2 * (2 * 2 * np_ * 72) + 2 * 2 * 64 * 200 + 2 * 2 * 64 * 72)
    assert section < smem.fwd_mma(n)
    assert smem.bytes_needed("K7", n, *FLAGSHIP, BF16) == max(
        section, smem.section(n, 64, 64, 1, BF16))
    assert smem.bytes_needed("K7", n, *FLAGSHIP, FP32) == smem.section(
        n, 64, 64, 1, FP32)
    assert smem.bytes_needed("K7", 81, *FLAGSHIP, BF16) == smem.section(
        81, 64, 64, 1, BF16)


@pytest.mark.parametrize("n,pd,embed,cluster", [
    (65, 320, 46080, 99072), (80, 320, 46080, 99072),
    (17, 320, 46080, 71936), (65, 160, 23040, 99072)])
def test_k1_layouts(n, pd, embed, cluster):
    """K1's tensor-core forms: the pe_w tile its embedding stages (pd rows
    of 72 bf16 values) fits under the forward body's bytes, so the
    two-frames-a-block form asks for fwd_mma(n); a CTA of the cluster
    form holds one head's k and v (rows padded to 16), its q|k|v and wout
    slices, over them the MLP's three-stage ring and the staged pe_w, then
    two fp32 partial tiles (16 x 64 a warp) and the CLS row. The largest
    of K1's forms sets its route's bytes: the FMA body's at 81 rows and
    more, the tensor-core body's at 80 and fewer."""
    assert smem.k1_embed(pd) == embed <= smem.fwd_mma(n)
    assert smem.k1_cluster(n, pd) == cluster < smem.fwd_mma(n)
    np_ = (n + 15) // 16 * 16
    parts = 2 * 4 * np_ * 64 + 4 * 64
    assert cluster == max(2 * 2 * np_ * 72 + 2 * 64 * 200 + 2 * 64 * 72,
                          3 * 2 * 2 * 64 * 72, embed) + parts
    assert smem.bytes_needed("K1", n, *FLAGSHIP, BF16) == max(
        smem.fwd_fma(n, *FLAGSHIP, BF16), smem.fwd_mma(n))
    assert smem.bytes_needed("K1", 81, *FLAGSHIP, BF16) == smem.fwd_fma(
        81, *FLAGSHIP, BF16)


# the longest frame each kernel holds at the H100's limit, flagship widths
LONGEST = {BF16: {"K1": 147, "K4": 147, "K2f": 147, "K3f": 147, "K2b": 110,
                  "K3b": 110, "K6": 110},
           FP32: {"K1": 89, "K4": 89, "K2f": 89, "K3f": 89, "K2b": 110,
                  "K3b": 110, "K6": 110}}


@pytest.mark.parametrize("dtype", [BF16, FP32], ids=["bf16", "fp32"])
def test_longest_frames(dtype):
    for kernel, n in LONGEST[dtype].items():
        assert smem.fits(kernel, n, *FLAGSHIP, dtype, H100), kernel
        assert not smem.fits(kernel, n + 1, *FLAGSHIP, dtype, H100), kernel
    for n in (65, 90, 129, 256):
        assert smem.fits("K7", n, *FLAGSHIP, dtype, H100)
        assert smem.fits("K2b", n, *FLAGSHIP, dtype, None)   # the CPU


def test_limit_for_the_cpu():
    assert smem.limit_for(torch.device("cpu")) is None
    assert smem.route_fits(smem.KERNELS, 256, *FLAGSHIP, BF16,
                           torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown kernel"):
        smem.bytes_needed("K9", 65, *FLAGSHIP, BF16)


def entry_spies(monkeypatch):
    """Record which fused entry point (or K7) each model call reaches."""
    seen = []

    def spy(mod, name, label):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            seen.append(label)
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    spy(got_mod, "got_forward_fused", "K1")
    spy(got_mod, "blocks_cls_forward_fused", "K4")
    spy(layers, "fused_transformer_block", "K2")
    spy(layers, "cls_final_block", "K3")
    spy(layers, "fused_attention_section", "K7")
    return seen


def strip_got(n, dtype, trunk_grad=False, depth=2):
    """A seeded GoT of the flagship widths on a (16, 20 (n - 1)) strip:
    n tokens."""
    torch.manual_seed(0)
    return GoT(image_size=(16, 20 * (n - 1)), patch_size=(16, 20), dim=64,
               depth=depth, heads=4, dim_head=64, mlp_dim=2048,
               emb_dropout=0.1, trunk_grad=trunk_grad, dtype=dtype)


# (dtype, tokens) -> the entry points of acting, the no-grad learn forward,
# the gradient route and the trunk-gradient route under the H100's limit
ROUTE_CASES = {
    (BF16, 65): (["K1"], ["K4"], ["K2", "K3"], ["K4"]),
    (BF16, 90): (["K1"], ["K4"], ["K2", "K3"], ["K4"]),
    (BF16, 129): (["K1"], ["K4"], ["K7", "K7"], ["K7", "K7"]),
    (BF16, 256): (["K7", "K7"], ["K7", "K7"], ["K7", "K7"], ["K7", "K7"]),
    (FP32, 65): (["K1"], ["K4"], ["K2", "K3"], ["K4"]),
    (FP32, 90): (["K7", "K7"], ["K7", "K7"], ["K7", "K7"], ["K7", "K7"]),
}


@pytest.mark.parametrize("dtype,n", list(ROUTE_CASES),
                         ids=[f"{'bf16' if d == BF16 else 'fp32'}-{n}"
                              for d, n in ROUTE_CASES])
def test_route_rule(dtype, n, monkeypatch):
    """Each route of GoT.forward (K1 acting, K4 no-grad, K2/K3 gradient,
    K4 + K6 trunk gradient) where its kernels hold the frame at the
    H100's limit, and the composed blocks (K7 a block) where they do
    not."""
    monkeypatch.setattr(smem, "limit_for", lambda device: H100)
    monkeypatch.setattr(layers, "_on_card", lambda t: True)
    seen = entry_spies(monkeypatch)
    rng = np.random.default_rng(n)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 16, 20 * (n - 1))).astype(
        np.float32))
    goal = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    got, trunk = strip_got(n, dtype), strip_got(n, dtype, trunk_grad=True)
    gen = lambda: torch.Generator().manual_seed(1)
    acting, learn, grad, trunk_grad = ROUTE_CASES[(dtype, n)]
    with torch.no_grad():
        got(img, goal, inference=True)
        assert seen == acting
        seen.clear()
        got(img, goal, inference=True, deterministic=False, generator=gen())
        assert seen == learn
    for model, want in ((got, grad), (trunk, trunk_grad)):
        seen.clear()
        out = model(img, goal, deterministic=False, generator=gen())
        out.float().sum().backward()
        assert seen == want
        assert all(p.grad is not None for p in model.parameters())


def test_cpu_routes_ignore_the_limit(monkeypatch):
    """On CPU tensors the rule sees no limit: 129 bf16 tokens keep the
    per-block kernels' (plain) route, as before the rule."""
    seen = entry_spies(monkeypatch)
    got = strip_got(129, BF16)
    img = torch.rand(1, 16, 20 * 128)
    out = got(img, torch.randn(1, 64), deterministic=False,
              generator=torch.Generator().manual_seed(1))
    out.float().sum().backward()
    assert seen == ["K2", "K3"]


def test_block_rule_without_autograd(monkeypatch):
    """The per-block route asks only for the forward kernel when autograd
    does not record: at 129 bf16 tokens K2f and K3f hold the frame and
    K2b does not."""
    monkeypatch.setattr(smem, "limit_for", lambda device: H100)
    blk = strip_got(129, BF16).transformer.blocks[0]
    x = torch.randn(1, 129, 64, dtype=BF16)
    assert not blk.fused_fits(x, cls_only=False)
    with torch.no_grad():
        assert blk.fused_fits(x, cls_only=False)
        assert blk.fused_fits(x, cls_only=True)


def section_args(n, dtype=BF16, d=64, heads=4, dim_head=64, shift=None):
    """K7's x, wqkv and wout at these widths; `shift` names the one moved
    2 bytes off a 16-byte boundary."""
    def make(*shape, name):
        t = torch.zeros(*shape, dtype=dtype)
        if name != shift:
            return t
        buf = torch.zeros(t.numel() + 1, dtype=dtype)
        return buf[1:].view(*shape)
    inner = heads * dim_head
    return (make(2, n, d, name="x"), make(d, 3 * inner, name="wqkv"),
            make(inner, d, name="wout"))


# (n, dtype, d, heads, dim_head, unaligned operand) -> tensor-core form
SECTION_ROUTES = [
    ((65, BF16, 64, 4, 64, None), True), ((80, BF16, 64, 4, 64, None), True),
    ((1, BF16, 64, 4, 64, None), True), ((65, BF16, 64, 2, 64, None), True),
    ((81, BF16, 64, 4, 64, None), False), ((256, BF16, 64, 4, 64, None),
                                           False),
    ((65, FP32, 64, 4, 64, None), False), ((65, BF16, 64, 2, 32, None),
                                           False),
    ((65, BF16, 128, 4, 64, None), False), ((65, BF16, 64, 4, 64, "x"),
                                            False),
    ((65, BF16, 64, 4, 64, "wqkv"), False), ((65, BF16, 64, 4, 64, "wout"),
                                             False)]


@pytest.mark.parametrize("args,mma", SECTION_ROUTES)
def test_k7_route_rule(args, mma):
    """K7 takes its tensor-core form only in bf16 at d = dim_head = 64, at
    most 80 tokens, with x, wqkv and wout 16-byte aligned (any head
    count); every other call takes the FMA kernel."""
    from dgvit_tpu_torch.ops.fused_block import tensor_core_section

    n, dtype, d, heads, dim_head, shift = args
    x, wqkv, wout = section_args(n, dtype, d, heads, dim_head, shift)
    assert tensor_core_section(x, wqkv, wout, dim_head) == mma


@pytest.mark.parametrize("cls", [True, False], ids=["K3f", "K2f"])
@pytest.mark.parametrize("n,dtype,shift,mma", [
    (65, BF16, None, True), (80, BF16, None, True), (81, BF16, None, False),
    (65, FP32, None, False), (65, BF16, "x", False), (65, BF16, "w1", False)])
def test_k3f_takes_the_tensor_core_body(cls, n, dtype, shift, mma,
                                        monkeypatch):
    """K3f launches the tensor-core forward body (cls_fwd_mma_kernel)
    exactly where K2f does (block_fwd_mma_kernel): bf16, d = dim_head =
    64, at most 80 tokens, x and the matrix weights aligned; the launch is
    recorded here, not made. In fp32 at those widths K2f and K3f launch
    their cluster forms (form 2)."""
    from dgvit_tpu_torch.ops import fused_transformer as ft

    launched = []
    monkeypatch.setattr(ft, "_block_lib", lambda: type(
        "Lib", (), {"block_forward_launch": None})())
    monkeypatch.setattr(ft, "_call", lambda fn, dt, c, tensors, x, heads,
                        dim_head, mlp, flag: launched.append((c, flag)))
    rng = np.random.default_rng(3)
    shapes = [(64,), (64,), (64, 768), (256, 64), (64,), (64,), (64,),
              (64, 2048), (2048,), (2048, 64), (64,)]
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dtype) for s in shapes]
    x = torch.zeros(2, n, 64, dtype=dtype)
    if shift == "x":
        x = torch.zeros(2 * n * 64 + 1, dtype=dtype)[1:].view(2, n, 64)
    if shift == "w1":
        w[7] = torch.zeros(64 * 2048 + 1, dtype=dtype)[1:].view(64, 2048)
    out = ft.launch_block_fwd(x, w, 4, 64, cls=cls)
    assert tuple(out.shape) == ((2, 64) if cls else (2, n, 64))
    cluster = dtype == FP32 and shift is None
    assert launched == [(cls, 2 if cluster else int(mma))]
