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
# and attention.cu)
BYTES = {
    (BF16, 65): {"K1": 102192, "K4": 142080, "K2b": 215056, "K3b": 136240,
                 "K6": 215056, "K7": 19776},
    (BF16, 90): {"K1": 141488, "K4": 141488, "K2b": 188640, "K3b": 188640,
                 "K6": 188640, "K7": 27168},
    (BF16, 129): {"K1": 202800, "K4": 202800, "K2b": 271440, "K3b": 271440,
                  "K6": 271440, "K7": 38720},
    (BF16, 256): {"K1": 402432, "K4": 402432, "K2b": 798720, "K3b": 798720,
                  "K6": 798720, "K7": 76288},
    (FP32, 65): {"K1": 168752, "K4": 168752, "K2b": 136240, "K3b": 136240,
                 "K6": 168752, "K7": 36672},
    (FP32, 90): {"K1": 233648, "K4": 233648, "K2b": 188640, "K3b": 188640,
                 "K6": 233648, "K7": 50464},
    (FP32, 129): {"K1": 334896, "K4": 334896, "K2b": 271440, "K3b": 271440,
                  "K6": 334896, "K7": 72000},
    (FP32, 256): {"K1": 664576, "K4": 664576, "K2b": 798720, "K3b": 798720,
                  "K6": 798720, "K7": 142080},
}


@pytest.mark.parametrize("dtype,n", list(BYTES),
                         ids=[f"{'bf16' if d == BF16 else 'fp32'}-{n}"
                              for d, n in BYTES])
def test_mirror_bytes(dtype, n):
    for kernel, want in BYTES[(dtype, n)].items():
        assert smem.bytes_needed(kernel, n, *FLAGSHIP, dtype) == want, kernel
    # K2f and K3f size like K4 and K1 (the same bodies)
    assert smem.bytes_needed("K2f", n, *FLAGSHIP, dtype) == \
        BYTES[(dtype, n)]["K4"]
    assert smem.bytes_needed("K3f", n, *FLAGSHIP, dtype) == \
        BYTES[(dtype, n)]["K1"]


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
    assert smem.bytes_needed("K3b", 17, *FLAGSHIP, FP32) == \
        smem.bwd_fma(17, 64, 2048)
    assert smem.fwd_mma(96) == smem.fwd_mma(80) + 3 * 2 * 16 * 72 * 2
    assert smem.bwd_mma(80) == 226816 <= H100
    # K7 takes the fewest query tiles that fit: one row always fits here
    assert smem.section(256, 64, 64, 256, FP32) > H100 \
        >= smem.section(256, 64, 64, 1, FP32)


# the longest frame each kernel holds at the H100's limit, flagship widths
LONGEST = {BF16: {"K1": 147, "K4": 147, "K2f": 147, "K3f": 147, "K2b": 110,
                  "K3b": 110, "K6": 110},
           FP32: {"K1": 89, "K4": 89, "K2f": 89, "K3f": 89, "K2b": 110,
                  "K3b": 110, "K6": 89}}


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
