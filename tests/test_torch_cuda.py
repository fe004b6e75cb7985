"""The CUDA kernels of patchfusion_tpu_torch against their plain twins, on a
card. Every test here needs CUDA and skips without it. This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up JAX for the rest of the suite).
"""

import ctypes

import numpy as np
import pytest
import torch

from patchfusion_tpu_torch.ops import fused_head, vit_attention

# a ragged output (42 rows, not a multiple of 8) at the head's widths
B, OH, OW, IH, IW, K, CIN, CC, HID = 2, 42, 56, 24, 30, 64, 33, 128, 80


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _nhwc(a: np.ndarray, dtype, dev, layout: str) -> torch.Tensor:
    """Channels-last tensor, contiguous or as a view of an NCHW tensor."""
    if layout == "nhwc":
        return torch.from_numpy(a).to(dev, dtype)
    t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
    return t.to(dev, dtype).permute(0, 2, 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhwc", "nchw-view"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_twins(cuda, dtype, layout):
    """f32 differs by float reassociation only (2e-4: p and t absolute,
    depth relative to max); bf16 also by the clb kernels' bf16 rounding of
    the bottleneck and GELU, which the f32 twin does not do (2e-2). The
    fused clb_logbinomial_depth runs the arithmetic of clb_pt then
    logbinomial_depth, so it matches that route to 1e-4 of max."""
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.random((B, OH, OW), dtype=np.float32) * 0.98
                         + 0.01).to(cuda)
    t = torch.from_numpy(rng.random((B, OH, OW), dtype=np.float32)).to(cuda)
    centers = _nhwc(rng.random((B, IH, IW, K), dtype=np.float32) * 70 + 1,
                    dtype, cuda, layout)
    last = _nhwc(rng.standard_normal((B, OH, OW, CIN), dtype=np.float32),
                 dtype, cuda, layout)
    cond = _nhwc(rng.standard_normal((B, IH, IW, CC), dtype=np.float32),
                 dtype, cuda, layout)
    ws = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.1)
          .to(cuda, dtype) for s in ((CIN + CC, HID), (HID,), (HID, 4),
                                     (4,))]
    before = dict(fused_head.LAUNCHES)

    d = fused_head.logbinomial_depth(p, t, centers)
    ref = fused_head.logbinomial_depth_plain(p, t, centers)
    got_p, got_t = fused_head.clb_pt(last, cond, *ws)
    ref_p, ref_t = fused_head.clb_pt_plain(last, cond, *ws)
    fused = fused_head.clb_logbinomial_depth(last, cond, centers, *ws)
    fused_ref = fused_head.clb_logbinomial_depth_plain(last, cond, centers,
                                                       *ws)
    two = fused_head.logbinomial_depth(got_p, got_t, centers)
    torch.cuda.synchronize()

    assert d.dtype == got_p.dtype == torch.float32
    assert (d - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert (got_p - ref_p).abs().max().item() <= tol
    assert (got_t - ref_t).abs().max().item() <= tol
    # logbinomial_depth ran twice: alone, and after clb_pt for `two`
    assert fused_head.LAUNCHES["logbinomial_depth"] == \
        before["logbinomial_depth"] + 2
    assert fused_head.LAUNCHES["clb_pt"] == before["clb_pt"] + 1
    assert fused.shape == (B, OH, OW) and fused.dtype == torch.float32
    peak = fused_ref.abs().max().item()
    assert (fused - fused_ref).abs().max().item() <= tol * peak
    assert (fused - two).abs().max().item() <= 1e-4 * two.abs().max().item()
    assert fused_head.LAUNCHES["clb_logbinomial_depth"] == \
        before["clb_logbinomial_depth"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhwc", "nchw-view"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,oh,ow,ih,iw", [
    (1, 45, 70, 26, 40),     # upsample ~1.75, as the head's
    (4, 47, 61, 15, 20),     # upsample ~3.2
    (1, 392, 518, 224, 296),  # the head's shape
    (4, 384, 512, 192, 256),  # the BEiT head's: a 2x upsample
])
def test_clb_pt_matches_twin(cuda, dtype, layout, b, oh, ow, ih, iw):
    """clb_pt at output shapes that are not multiples of the bf16 kernel's
    8 x 32 tiles and at upsample ratios below and above 2: within 2e-4 (f32)
    and 2e-2 (bf16, which rounds the bottleneck and GELU) of the twin."""
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    rng = np.random.default_rng(oh)
    last = _nhwc(rng.standard_normal((b, oh, ow, CIN), dtype=np.float32),
                 dtype, cuda, layout)
    cond = _nhwc(rng.standard_normal((b, ih, iw, CC), dtype=np.float32),
                 dtype, cuda, layout)
    ws = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.1)
          .to(cuda, dtype) for s in ((CIN + CC, HID), (HID,), (HID, 4),
                                     (4,))]
    before = fused_head.LAUNCHES["clb_pt"]
    got_p, got_t = fused_head.clb_pt(last, cond, *ws)
    ref_p, ref_t = fused_head.clb_pt_plain(last, cond, *ws)
    torch.cuda.synchronize()
    assert fused_head.LAUNCHES["clb_pt"] == before + 1
    assert got_p.shape == (b, oh, ow) and got_p.dtype == torch.float32
    assert bool(torch.isfinite(got_p).all() and torch.isfinite(got_t).all())
    assert (got_p - ref_p).abs().max().item() <= tol
    assert (got_t - ref_t).abs().max().item() <= tol


# (B, OH, OW, IH, IW, K) of the fused clb_logbinomial_depth: both heads'
# shapes at B = 1 and 4, K = 128 (its largest; 4-row tiles at this shape),
# an odd K, and outputs ragged in both axes at ~1.75x and ~3.2x
FUSED_SHAPES = {
    "head_b1": (1, 392, 518, 224, 296, 64),
    "head_b4": (4, 392, 518, 224, 296, 64),
    "beit_head_b1": (1, 384, 512, 192, 256, 64),
    "beit_head_b4": (4, 384, 512, 192, 256, 64),
    "head_k128": (2, 392, 518, 224, 296, 128),
    "ragged_k63": (2, 45, 70, 26, 40, 63),
    "ragged_3x": (3, 47, 61, 15, 20, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhwc", "nchw-view"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(FUSED_SHAPES))
def test_clb_logbinomial_depth_matches_twin_and_pair(cuda, dtype, layout,
                                                     shape):
    """The fused kernel, one launch, against its twin (2e-4 f32, 2e-2 bf16,
    relative to max) and against clb_pt then logbinomial_depth (1e-4: the
    bf16 kernel runs their arithmetic; NCHW views take its TMA copies,
    NHWC its element loads); its plan's bytes are the C layout's."""
    b, oh, ow, ih, iw, k = FUSED_SHAPES[shape]
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    rng = np.random.default_rng(oh + k)
    centers = _nhwc(rng.random((b, ih, iw, k), dtype=np.float32) * 70 + 1,
                    dtype, cuda, layout)
    last = _nhwc(rng.standard_normal((b, oh, ow, CIN), dtype=np.float32),
                 dtype, cuda, layout)
    cond = _nhwc(rng.standard_normal((b, ih, iw, CC), dtype=np.float32),
                 dtype, cuda, layout)
    ws = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.1)
          .to(cuda, dtype) for s in ((CIN + CC, HID), (HID,), (HID, 4),
                                     (4,))]
    before = fused_head.LAUNCHES["clb_logbinomial_depth"]
    got = fused_head.clb_logbinomial_depth(last, cond, centers, *ws)
    assert fused_head.LAUNCHES["clb_logbinomial_depth"] == before + 1
    ref = fused_head.clb_logbinomial_depth_plain(last, cond, centers, *ws)
    two = fused_head.logbinomial_depth(*fused_head.clb_pt(last, cond, *ws),
                                       centers)
    torch.cuda.synchronize()
    assert got.shape == (b, oh, ow) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert (got - two).abs().max().item() <= 1e-4 * two.abs().max().item()
    if dtype == torch.bfloat16:
        tma = sum(bit * fused_head.tma_ok(x) for bit, x in (
            (fused_head.TMA_COND, cond), (fused_head.TMA_CENT, centers),
            (fused_head.TMA_LAST, last)))
        plan = fused_head.clb_depth_plan(oh, ow, ih, iw, CIN, k, tma)
        ints = (ctypes.c_int * len(plan))(*plan)
        assert fused_head.load_kernels().pf_clb_depth_smem(
            ints, CIN, k) == plan.smem


def _depth_inputs(b, oh, ow, ih, iw, k, dtype, dev, layout, seed):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.random((b, oh, ow), dtype=np.float32) * 0.98
                         + 0.01).to(dev)
    t = torch.from_numpy(rng.random((b, oh, ow), dtype=np.float32)).to(dev)
    centers = _nhwc(rng.random((b, ih, iw, k), dtype=np.float32) * 70 + 1,
                    dtype, dev, layout)
    return p, t, centers


# (B, OH, OW, IH, IW, K)
DEPTH_SHAPES = {
    "head_b1": (1, 392, 518, 224, 296, 64),
    "beit_head_b4": (4, 384, 512, 192, 256, 64),
    "small": (2, 42, 56, 24, 30, 64),
    "k100": (2, 42, 56, 24, 30, 100),
    "k300": (2, 42, 56, 24, 30, 300),
    "same_size_k63": (1, 42, 56, 42, 56, 63),
    "downsample": (1, 42, 56, 90, 120, 64),
    "steep_downsample": (1, 42, 56, 420, 560, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhwc", "nchw-view"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(DEPTH_SHAPES))
def test_logbinomial_depth_matches_twin(cuda, shape, dtype, layout):
    """Within 2e-4 of max |depth| of the twin in both dtypes: the kernel
    reads the bf16 centers exactly, and only the order of its sums and
    ex2.approx part it from the twin. The shapes: the head's at B = 1
    (392 x 518, ragged for the 8 x 64 tile), a small ragged one, a chunk
    of bins, a ragged chunk and several chunks (K 64, 100, 300), no
    upsample with an odd K, a downsample, and a downsample too steep for
    the tiled kernel's window (the per-pixel kernel)."""
    dims = DEPTH_SHAPES[shape]
    p, t, centers = _depth_inputs(*dims, dtype, cuda, layout, seed=dims[5])
    before = dict(fused_head.LAUNCHES)
    got = fused_head.logbinomial_depth(p, t, centers)
    ref = fused_head.logbinomial_depth_plain(p, t, centers)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= 2e-4 * ref.abs().max().item()
    ran = sum(fused_head.LAUNCHES[n] - before[n]
              for n in ("logbinomial_depth", "logbinomial_depth_pixel"))
    assert ran == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("shape", ["head", "beit_head", "steep_downsample"])
def test_logbinomial_depth_picks_its_kernel(cuda, shape, b):
    """The DA and BEiT heads' shapes (bf16, NCHW view, B = 1 and 4) take
    the tiled kernel; a 10x downsample of the centers the per-pixel one."""
    dims = (b, *DEPTH_SHAPES[{"head": "head_b1", "beit_head": "beit_head_b4",
                              "steep_downsample": "steep_downsample"}[shape]
                             ][1:])
    want = "logbinomial_depth_pixel" if shape == "steep_downsample" \
        else "logbinomial_depth"
    p, t, centers = _depth_inputs(*dims, torch.bfloat16, cuda, "nchw-view",
                                  seed=b)
    before = dict(fused_head.LAUNCHES)
    fused_head.logbinomial_depth(p, t, centers)
    torch.cuda.synchronize()
    assert {n: fused_head.LAUNCHES[n] - before[n] for n in before} == \
        {n: int(n == want) for n in before}


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    p = torch.rand(1, 8, 10, device=cuda)
    centers = torch.rand(1, 4, 5, 64, device=cuda)
    with pytest.raises(TypeError):
        fused_head.logbinomial_depth(p.double(), p, centers)
    with pytest.raises(ValueError):  # a strided slice: neither layout
        fused_head.logbinomial_depth(p, p, centers[:, :, ::2])
    last = torch.rand(1, 8, 10, 33, device=cuda)
    cond = torch.rand(1, 4, 5, 128, device=cuda)
    w = [torch.rand(s, device=cuda) for s in ((161, 64), (64,), (64, 4),
                                              (4,))]
    with pytest.raises(ValueError):  # hidden width other than 80
        fused_head.clb_pt(last, cond, *w)
    w = [torch.rand(s, device=cuda) for s in ((161, 80), (80,), (80, 4),
                                              (4,))]
    with pytest.raises(ValueError):  # a strided slice: neither layout
        fused_head.clb_logbinomial_depth(last, cond, centers[:, :, ::2],
                                         *w)
    with pytest.raises(TypeError):  # centers in another dtype
        fused_head.clb_logbinomial_depth(last, cond, centers.double(), *w)
    # the bf16 clb_pt kernel: 128 condition channels, up to 48 inputs, and
    # an upsample steep enough for its tile footprint
    bf = torch.bfloat16
    w_bf = [x.to(bf) for x in w]
    w64 = [torch.rand(s, device=cuda, dtype=bf) for s in ((97, 80), (80,),
                                                          (80, 4), (4,))]
    with pytest.raises(ValueError):  # 64 condition channels
        fused_head.clb_pt(last.to(bf), cond[..., :64].to(bf), *w64)
    w_wide = [torch.rand(s, device=cuda, dtype=bf) for s in ((178, 80),
                                                             (80,), (80, 4),
                                                             (4,))]
    with pytest.raises(ValueError):  # 50 input channels
        fused_head.clb_pt(torch.rand(1, 8, 10, 50, device=cuda, dtype=bf),
                          cond.to(bf), *w_wide)
    with pytest.raises(ValueError):  # a downsample
        fused_head.clb_pt(last.to(bf), torch.rand(1, 16, 20, 128, device=cuda,
                                                  dtype=bf), *w_bf)
    with pytest.raises(ValueError):  # no upsample: the footprint is too big
        fused_head.clb_pt(torch.rand(1, 64, 64, 33, device=cuda, dtype=bf),
                          torch.rand(1, 64, 64, 128, device=cuda, dtype=bf),
                          *w_bf)
    with pytest.raises(ValueError):  # more bins than the staged centers take
        fused_head.clb_logbinomial_depth(
            last.to(bf), cond.to(bf),
            torch.rand(1, 4, 5, 130, device=cuda, dtype=bf), *w_bf)


def _qkv(rng, b, n, h, dh, dev, max_first=False):
    """q, k, v as the model hands them: views qkv[:, :, i] of the qkv
    linear's (B, N, 3, H, Dh) output. max_first: every row's largest logit
    lies at key 0, ~6 above the rest, so the kernel's running max is the
    row max from its first key tile on."""
    qkv = rng.standard_normal((b, n, 3, h, dh), dtype=np.float32)
    if max_first:
        qkv[:, :, :2] *= 0.6
        qkv[:, :, 0, :, 0] = 1.0
        qkv[:, :, 1, :, 0] = 0.0
        qkv[:, 0, 1, :, 0] = round(6.0 * dh ** 0.5)
    qkv = torch.from_numpy(qkv).to(dev, torch.bfloat16)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


# wrapper -> the twin's rounding (round_logits, round_diff)
ROUNDINGS = {
    "vit_attention": (lambda q, k, v: vit_attention.vit_attention(q, k, v),
                      (True, True)),
    "blocked": (lambda q, k, v: vit_attention.vit_attention_blocked(
        q, k, v, block_rows=128), (False, False)),
    "mxsum_bf16_exp": (lambda q, k, v: vit_attention.vit_attention_mxsum(
        q, k, v, bf16_exp=True), (False, True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("h", [3, 16])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("n", [37, 130, 1037])
@pytest.mark.parametrize("wrapper", list(ROUNDINGS))
def test_attention_kernel_matches_twin(cuda, wrapper, n, dh, b, h):
    """Ragged N (not a multiple of the 128-key tiles), strided qkv views,
    both query tiles (192 rows for Dh <= 64, 128 above), one launch per
    call; H = 16 with N = 1037 and Dh = 64 is the vitl grid, at B = 1 (the
    coarse pass: one partial wave of items) and B = 4. The kernel rounds P
    to bf16 against its running max, the twin against the whole-row max,
    and they sum in another order: 1e-2 absolute on outputs of |o| < ~1."""
    fn, rounding = ROUNDINGS[wrapper]
    q, k, v = _qkv(np.random.default_rng(n + dh), b, n, h, dh, cuda)
    before = vit_attention.LAUNCHES["vit_attention"]
    got = fn(q, k, v)
    ref = vit_attention.vit_attention_plain(q, k, v, *rounding)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    assert (got.float() - ref.float()).abs().max().item() <= 1e-2
    assert vit_attention.LAUNCHES["vit_attention"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("n", [37, 130, 1037])
@pytest.mark.parametrize("wrapper", list(ROUNDINGS))
def test_attention_kernel_keeps_its_rounding(cuda, wrapper, n, dh):
    """Each wrapper's output is nearer its own rounding's twin than any
    other rounding's: on inputs whose row maxima lie in the first key tile
    the kernel and its own twin differ only by the order of f32 sums, while
    the roundings part by ~1e-4 to 1e-3 in the mean. So a wrapper that
    sent another rounding's flags, or a kernel that ignored one, fails
    here although it would pass the 1e-2 bound above."""
    fn, _ = ROUNDINGS[wrapper]
    q, k, v = _qkv(np.random.default_rng(n + dh), 2, n, 3, dh, cuda,
                   max_first=True)
    got = fn(q, k, v).float()
    dist = {other: (got - vit_attention.vit_attention_plain(
        q, k, v, *rounding).float()).abs().mean().item()
        for other, (_, rounding) in ROUNDINGS.items()}
    nearest = min(d for other, d in dist.items() if other != wrapper)
    assert dist[wrapper] <= 0.25 * nearest, dist


@pytest.mark.cuda
def test_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(np.random.default_rng(0), 1, 20, 2, 64, cuda)
    with pytest.raises(TypeError):
        vit_attention.vit_attention(q.float(), k.float(), v.float())
    q72, k72, v72 = _qkv(np.random.default_rng(0), 1, 20, 2, 72, cuda)
    with pytest.raises(ValueError):
        vit_attention.vit_attention(q72, k72, v72)
    q144, k144, v144 = _qkv(np.random.default_rng(0), 1, 20, 2, 144, cuda)
    with pytest.raises(ValueError):  # wider than the kernel's 128
        vit_attention.vit_attention(q144, k144, v144)
    wide = torch.zeros(1, 20, 2, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # Dh not contiguous
        vit_attention.vit_attention(q, k, wide[..., ::2])
    odd = torch.zeros(1, 20, 2 * 64 + 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a token stride TMA cannot take
        vit_attention.vit_attention(q, k, odd[..., :128].view(1, 20, 2, 64))


# -- the eval path: snapshot load and the fusion-less engine ----------------

def _head_launches():
    return (fused_head.LAUNCHES["clb_pt"],
            fused_head.LAUNCHES["logbinomial_depth"]
            + fused_head.LAUNCHES["logbinomial_depth_pixel"])


def _tiny_images():
    rng = np.random.default_rng(7)
    return (rng.random((1, 42, 56, 3), dtype=np.float32),
            rng.random((84, 112, 3), dtype=np.float32))


@pytest.mark.cuda
def test_snapshot_loads_on_the_card_as_on_the_cpu(cuda, tmp_path):
    """A tiny snapshot directory loaded on the card in bf16 holds the CPU
    load's weights, rounded, and its m1 depth is within the tiny check's
    3e-2 of max of the f32 CPU depth, with the head kernels launched once
    per metric-bins head (coarse, then fine and PF per chunk of 2)."""
    import json

    import chip_smoke
    from patchfusion_tpu_torch.api import PatchFusion

    cfg = chip_smoke.tiny_config()
    seeded = PatchFusion.from_config(cfg, device="cpu", seed=2)
    snap = tmp_path / "snap"
    snap.mkdir()
    torch.save(seeded.net.state_dict(), snap / "pytorch_model.bin")
    (snap / "config.json").write_text(json.dumps({"config": cfg}))
    cpu = PatchFusion.from_pretrained(str(snap), device="cpu")
    gpu = PatchFusion.from_pretrained(str(snap), device="cuda",
                                      dtype=torch.bfloat16)
    want_sd = cpu.net.state_dict()
    for k, v in gpu.net.state_dict().items():
        assert v.is_cuda
        want = want_sd[k].to(v.dtype).to(cuda)
        torch.testing.assert_close(v, want, rtol=0, atol=0)
    lr, hr = _tiny_images()
    ref = cpu.infer(lr, hr, cai_mode="m1", process_num=2)
    before = _head_launches()
    got = gpu.infer(lr, hr, cai_mode="m1", process_num=2)
    ran = tuple(a - b for a, b in zip(_head_launches(), before))
    assert ran == (5, 5)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel <= 3e-2, rel


@pytest.mark.cuda
def test_fusionless_engine_runs_the_head_kernels(cuda):
    """BaselinePretrain's fine target on the card in bf16: one fine head per
    chunk of 2 tiles, no coarse pass (m1: 4 tiles, 2 launches of each head
    kernel; r1: the 9 tiles of the four regular passes in 5 chunks, then
    one group of 2 random tiles); depth within 3e-2 of max of the same
    weights in f32 on the CPU."""
    import chip_smoke
    from patchfusion_tpu_torch.api import BaselinePretrain

    branch = chip_smoke.tiny_config()["fine_branch"]
    kw = dict(target="fine", image_raw_shape=(84, 112),
              patch_split_num=(2, 2), patch_process_shape=(42, 56))
    cpu = BaselinePretrain(branch, 1e-3, 80, device="cpu", seed=3, **kw)
    gpu = BaselinePretrain(branch, 1e-3, 80, device="cuda",
                           dtype=torch.bfloat16,
                           state_dict=cpu.net.state_dict(), **kw)
    lr, hr = _tiny_images()
    for mode, heads in (("m1", 2), ("r1", 5 + 1)):
        rand = gpu.engine(2).random_origins(2, np.random.default_rng(1))
        ref = cpu.infer(lr, hr, cai_mode=mode, process_num=2,
                        rand_origins=rand if mode == "r1" else None)
        before = _head_launches()
        got = gpu.infer(lr, hr, cai_mode=mode, process_num=2,
                        rand_origins=rand if mode == "r1" else None)
        ran = tuple(a - b for a, b in zip(_head_launches(), before))
        assert ran == (heads, heads), (mode, ran)
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel <= 3e-2, (mode, rel)


def _grad_inputs(name, dtype, dev):
    """Seeded inputs of one head wrapper on the card at the ragged test
    shape, the 4-D maps in `dtype` as permuted views of NCHW leaves (the
    model's layout), p, t and the weights f32; returns (leaves, args)."""
    rng = np.random.default_rng(11)

    def nchw_view(shape):
        leaf = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
            rng.standard_normal(shape, dtype=np.float32), -1, 1))).to(
            dev, dtype).requires_grad_()
        return leaf, leaf.permute(0, 2, 3, 1)

    def flat(a):
        leaf = torch.from_numpy(a).to(dev).requires_grad_()
        return leaf, leaf

    pairs = []
    if name == "logbinomial_depth":
        pairs += [flat(rng.random((B, OH, OW), dtype=np.float32) * 0.98
                       + 0.01),
                  flat(rng.random((B, OH, OW), dtype=np.float32))]
        leaf, view = nchw_view((B, IH, IW, K))
        with torch.no_grad():  # positive centers
            leaf.abs_().mul_(30).add_(1)
        pairs.append((leaf, view))
        return pairs
    pairs += [nchw_view((B, OH, OW, CIN)), nchw_view((B, IH, IW, CC))]
    if name == "clb_logbinomial_depth":
        leaf, view = nchw_view((B, IH, IW, K))
        with torch.no_grad():
            leaf.abs_().mul_(30).add_(1)
        pairs.append((leaf, view))
    pairs += [flat((rng.standard_normal(s) * 0.1).astype(np.float32))
              for s in ((CIN + CC, HID), (HID,), (HID, 4), (4,))]
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["clb_pt", "logbinomial_depth",
                                  "clb_logbinomial_depth"])
def test_head_gradients_match_the_twins(cuda, name, dtype):
    """Each head wrapper on the card with inputs that require grad: the
    forward is its kernel (one launch, the same output as the kernel
    without grad), and the gradients of every input (the recomputed twin's)
    agree with plain autograd through the twin on the same inputs, each in
    its input's dtype and shape: within 1e-5 of each gradient's max in f32
    (the same arithmetic; the bilinear resizes' backward sums with atomics
    in any order), within 2^-7 of max for a bf16 input, whose gradient the
    twin rounds to bf16 last (a sum that differs in its last f32 bits may
    round to the neighbouring bf16 value)."""
    wrapper = getattr(fused_head, name)
    plain = getattr(fused_head, name + "_plain")
    got_pairs = _grad_inputs(name, dtype, cuda)
    want_pairs = _grad_inputs(name, dtype, cuda)
    with torch.no_grad():
        ref_out = wrapper(*(v for _, v in got_pairs))
    before = fused_head.LAUNCHES[name]
    out = wrapper(*(v for _, v in got_pairs))
    assert fused_head.LAUNCHES[name] == before + 1
    out = out if isinstance(out, tuple) else (out,)
    ref_out = ref_out if isinstance(ref_out, tuple) else (ref_out,)
    for o, r in zip(out, ref_out):
        assert torch.equal(o, r)
    want = plain(*(v for _, v in want_pairs))
    want = want if isinstance(want, tuple) else (want,)
    cot = [torch.randn(o.shape, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(i))
           for i, o in enumerate(out)]
    torch.autograd.backward(out, cot)
    torch.autograd.backward(want, cot)
    torch.cuda.synchronize()
    assert fused_head.LAUNCHES[name] == before + 1  # no kernel in backward
    for (g, _), (w, _) in zip(got_pairs, want_pairs):
        assert g.grad.shape == g.shape and g.grad.dtype == g.dtype
        err = (g.grad.float() - w.grad.float()).abs().max()
        tol = 1e-5 if g.dtype == torch.float32 else 2 ** -7
        assert err <= tol * w.grad.float().abs().max(), name


@pytest.mark.cuda
def test_attention_kernel_raises_under_grad(cuda):
    """No backward for the attention kernel: a call that would carry a
    gradient raises and launches nothing; under no_grad it launches."""
    qkv = torch.randn((1, 37, 3, 2, 64), device=cuda, dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, i].clone().requires_grad_() for i in range(3))
    before = vit_attention.LAUNCHES["vit_attention"]
    with pytest.raises(RuntimeError, match="PF_ATTN_IMPL"):
        vit_attention.vit_attention(q, k, v)
    assert vit_attention.LAUNCHES["vit_attention"] == before
    with torch.no_grad():
        vit_attention.vit_attention(q, k, v)
    assert vit_attention.LAUNCHES["vit_attention"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16, 49])
def test_attention_kernel_at_the_vits_batches(cuda, b):
    """The kernel against its twin at DINOv2-S's 6 heads and the batches
    its cells run (16 tiles in one pass, 49 in one pass), N = 1037 and
    Dh = 64 through the qkv views: the bound of
    test_attention_kernel_matches_twin, one launch."""
    q, k, v = _qkv(np.random.default_rng(b), b, 1037, 6, 64, cuda)
    before = vit_attention.LAUNCHES["vit_attention"]
    got = vit_attention.vit_attention(q, k, v)
    ref = vit_attention.vit_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    assert (got.float() - ref.float()).abs().max().item() <= 1e-2
    assert vit_attention.LAUNCHES["vit_attention"] == before + 1


def _parent_fused_attention(q, k, v, impl=None):
    """models/dinov2.fused_attention before the kernel became the default
    bf16 route: dense in f32; in bf16 the einsum path unless "pallas" is
    asked for."""
    import os

    if q.dtype != torch.bfloat16:
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * q.shape[-1] ** -0.5
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhnm,bmhd->bnhd", probs, v)
    if (impl or os.environ.get("PF_ATTN_IMPL", "einsum")) == "pallas":
        return vit_attention.vit_attention(q, k, v)
    return vit_attention.vit_attention_plain(q, k, v)


def _tiny_bf16_model():
    import chip_smoke
    from patchfusion_tpu_torch.api import PatchFusion

    model = PatchFusion.from_config(chip_smoke.tiny_config(), device="cuda",
                                    dtype=torch.bfloat16, seed=0)
    blocks = [len(branch.core.core.pretrained.blocks) for branch in
              (model.net.coarse_branch, model.net.fine_branch)]
    return model, blocks


@pytest.mark.cuda
def test_request_runs_the_attention_kernel_by_default(cuda, monkeypatch):
    """A warm seeded tiny m2 request with PF_ATTN_IMPL unset launches the
    attention kernel once per DINOv2 block of the coarse pass and of each
    chunk's fine pass (the tracer's launches.vit_attention: blocks x (1 +
    chunks)); its depth is within chip_smoke's PATH_TOL of the same
    request with PF_ATTN_IMPL=einsum, which launches none."""
    import chip_smoke
    from patchfusion_tpu_torch.utils import profiling

    model, blocks = _tiny_bf16_model()
    lr, hr = _tiny_images()
    depths, counters = {}, {}
    for impl in (None, "einsum"):
        if impl is None:
            monkeypatch.delenv("PF_ATTN_IMPL", raising=False)
        else:
            monkeypatch.setenv("PF_ATTN_IMPL", impl)
        model.infer(lr, hr, cai_mode="m2", process_num=2)  # warm
        profiling.enable()
        try:
            depths[impl] = model.infer(lr, hr, cai_mode="m2", process_num=2)
            (rec,) = profiling.records()
        finally:
            profiling.disable()
            profiling.clear()
        counters[impl] = rec["counters"]
    chunks = counters[None]["chunks"]
    assert chunks == 5
    assert counters[None]["launches.vit_attention"] \
        == blocks[0] + chunks * blocks[1]
    assert counters["einsum"]["launches.vit_attention"] == 0
    ref = depths["einsum"]
    rel = float(np.abs(depths[None] - ref).max() / np.abs(ref).max())
    assert rel <= chip_smoke.PATH_TOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_einsum_variable_keeps_the_parent_route(cuda, monkeypatch, mode):
    """PF_ATTN_IMPL=einsum gives the depth of the dispatch before the
    kernel became the default, bit for bit, and launches no attention
    kernel."""
    from patchfusion_tpu_torch.models import dinov2

    model, _ = _tiny_bf16_model()
    lr, hr = _tiny_images()
    monkeypatch.setenv("PF_ATTN_IMPL", "einsum")
    before = vit_attention.LAUNCHES["vit_attention"]
    got = model.infer(lr, hr, cai_mode=mode, process_num=2)
    monkeypatch.delenv("PF_ATTN_IMPL")
    monkeypatch.setattr(dinov2, "fused_attention", _parent_fused_attention)
    want = model.infer(lr, hr, cai_mode=mode, process_num=2)
    assert vit_attention.LAUNCHES["vit_attention"] == before
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_branch_step_launches_no_attention_kernel(cuda, monkeypatch):
    """Branch pretraining on the card with PF_ATTN_IMPL unset: one coarse
    step of the tiny branch as the branch CLI runs it (f32), and the
    forward of its DINOv2 backbone in bf16 with trainable weights (every
    attention bf16 and carrying a gradient). Neither launches the
    attention kernel, and the step's loss and the backbone's outputs are
    those of the dispatch before the kernel became the default, bit for
    bit. The f32 step is a control: fused_attention sends every f32 call
    to dense attention before the bf16 route is chosen, so it holds
    whatever that route does. The bf16 forward is what checks the rule
    that a gradient-carrying call takes the einsum path. Its backward is
    not taken: the einsum path's f32-output bmm
    (`torch.bmm(..., out_dtype=)`) has no derivative on the card, at the
    parent as here."""
    import chip_smoke
    from patchfusion_tpu_torch.api import BaselinePretrain
    from patchfusion_tpu_torch.engine import training
    from patchfusion_tpu_torch.models import dinov2
    from patchfusion_tpu_torch.models.builder import build_zoedepth_branch

    monkeypatch.delenv("PF_ATTN_IMPL", raising=False)
    bcfg = chip_smoke.tiny_config()["coarse_branch"]
    weights = BaselinePretrain(
        bcfg, 1e-3, 80.0, target="coarse", image_raw_shape=(84, 112),
        patch_split_num=(2, 2), patch_process_shape=(42, 56), device="cpu",
        seed=3).net.state_dict()
    rng = np.random.default_rng(4)
    batch = {"image_lr": rng.random((2, 42, 56, 3), dtype=np.float32),
             "depth_gt": rng.random((2, 42, 56, 1), dtype=np.float32) * 40
             + 1}
    image = torch.from_numpy(batch["image_lr"]).to(cuda).permute(0, 3, 1, 2)
    vit = build_zoedepth_branch(bcfg, 1e-3, 80.0, dtype=torch.bfloat16,
                                device="cuda")
    vit.load_state_dict(weights)
    vit = vit.core.core.pretrained.requires_grad_(True)

    def step():
        branch = build_zoedepth_branch(bcfg, 1e-3, 80.0, device="cuda")
        branch.load_state_dict(weights)
        state = training.create_branch_state(
            branch, training.make_onecycle_optimizer(1e-4, 10))
        tb = training.to_device_batch(batch, cuda, ("image_lr", "depth_gt"))
        logs = training.make_branch_train_step("coarse", 1e-3, 80.0)(
            state, tb)
        return float(logs["total_loss"])

    def backbone():
        taps = [x for tap in vit(image.to(torch.bfloat16)) for x in tap]
        assert all(x.requires_grad for x in taps)
        return [x.detach() for x in taps]

    before = vit_attention.LAUNCHES["vit_attention"]
    got_loss, got_taps = step(), backbone()
    torch.cuda.synchronize()
    assert vit_attention.LAUNCHES["vit_attention"] == before
    monkeypatch.setattr(dinov2, "fused_attention", _parent_fused_attention)
    want_loss, want_taps = step(), backbone()
    assert np.isfinite(got_loss) and got_loss == want_loss, (got_loss,
                                                             want_loss)
    assert all(torch.equal(g, w) for g, w in zip(got_taps, want_taps))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_world_one_batchnorm_and_silog_unchanged(cuda, dtype):
    """Without a process group, FlaxBatchNorm2d's train mode and SILogLoss
    take their single-process route on the card, bitwise: F.batch_norm on
    the batch statistics with flax's running-statistics update, and the
    masked SILog in one pass over the batch."""
    import torch.nn.functional as F

    from patchfusion_tpu_torch.models.fusion import FlaxBatchNorm2d
    from patchfusion_tpu_torch.models.losses import SILogLoss

    assert not torch.distributed.is_initialized()
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(4, 32, 24, 30, device=cuda, generator=gen).to(dtype)
    bn = FlaxBatchNorm2d(32).to(cuda).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(generator=gen)
    y = bn(x)
    var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
    assert torch.equal(y, F.batch_norm(x, None, None, bn.weight, bn.bias,
                                       True, 0.0, bn.eps))
    assert torch.equal(bn.running_mean, torch.zeros(32, device=cuda)
                       .lerp_(mean, 0.1))
    assert torch.equal(bn.running_var, torch.ones(32, device=cuda)
                       .lerp_(var, 0.1))

    pred = (torch.rand(4, 1, 24, 30, device=cuda, generator=gen) * 40
            + 1).to(dtype)
    gt = torch.rand(4, 1, 24, 30, device=cuda, generator=gen) * 40 + 1
    gt[0, :, :5] = 0.0
    mask = (gt > 1e-3) & (gt < 80.0)
    n = mask.sum().float()
    g = torch.where(mask, torch.log(pred.float() + 1e-7)
                    - torch.log(gt + 1e-7), 0.0)
    m = g.sum() / n.clamp(min=1.0)
    v = torch.where(mask, (g - m) ** 2, 0.0).sum() / (n - 1.0).clamp(min=1.0)
    want = 10.0 * torch.sqrt(v + 0.15 * m ** 2)
    assert torch.equal(SILogLoss()(pred, gt, 1e-3, 80.0), want)


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card(cuda, monkeypatch):
    """Under nccl, a local rank without a card of its own (two ranks on
    one card) raises before any rendezvous, naming the cause."""
    from patchfusion_tpu_torch.parallel import dist

    local = torch.cuda.device_count()
    monkeypatch.setenv("WORLD_SIZE", str(local + 1))
    monkeypatch.setenv("RANK", str(local))
    monkeypatch.setenv("LOCAL_RANK", str(local))
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(RuntimeError, match="one card|one device"):
        dist.init_distributed(device="cuda")
    assert not torch.distributed.is_initialized()


@pytest.mark.cuda
def test_tracer_records_device_times_on_the_card(cuda):
    """The span tracer on the card (utils/profiling): one record per
    request, each span's device interval inside its parent's (one stream,
    so its events are ordered), the wrapper calls' spans on the host only,
    the head kernels' launches as counters, and
    the depth the same bit for bit as with the tracer off."""
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.tools._bench_util import tiny_config
    from patchfusion_tpu_torch.utils import profiling

    model = PatchFusion.from_config(tiny_config(), device="cuda",
                                    dtype=torch.bfloat16, seed=0)
    rng = np.random.default_rng(3)
    lr = rng.random((1, 42, 56, 3), dtype=np.float32)
    hr = rng.random((84, 112, 3), dtype=np.float32)
    off = model.infer(lr, hr, cai_mode="m2", process_num=2)
    profiling.enable()
    try:
        on = [model.infer(lr, hr, cai_mode="m2", process_num=2)
              for _ in range(2)]
        recs = profiling.records()
    finally:
        profiling.disable()
        profiling.clear()
    assert all(np.array_equal(off, d) for d in on) and len(recs) == 2
    for rec in recs:
        spans = rec["spans"]
        assert rec["device"].startswith("cuda") and not rec["failed"]
        assert spans[0]["dev_start_ms"] == 0.0
        for s in spans[1:]:
            p = spans[s["parent"]]
            if s["name"].startswith(("pf.attn", "pf.head.")):
                # host-only spans
                assert s["dev_start_ms"] is None, s
                continue
            assert p["dev_start_ms"] <= s["dev_start_ms"] \
                <= s["dev_end_ms"] <= p["dev_end_ms"], (s, p)
        c = rec["counters"]
        # the coarse head, then each of the 5 chunks' fine and PF heads
        assert c["chunks"] == 5 and c["launches.clb_pt"] == 11
        assert c["launches.logbinomial_depth"] \
            + c["launches.logbinomial_depth_pixel"] == 11
        assert c["h2d_bytes"] == (42 * 56 + 84 * 112) * 3 * 4


@pytest.mark.cuda
def test_warm_request_uploads_only_its_images(cuda):
    """A warm m2 request of the tiny config under torch.profiler, the
    tracer on for its `pf.` ranges: outside `pf.coarse` and `pf.chunk` it
    copies two things from the host, the two images, and no copy to or
    from the host runs inside `pf.stitch`. The blend mask and the regular
    passes' boxes are the engine's tile plan, uploaded by the first
    request."""
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.tools._bench_util import tiny_config
    from patchfusion_tpu_torch.utils import profiling

    model = PatchFusion.from_config(tiny_config(), device="cuda",
                                    dtype=torch.bfloat16, seed=0)
    lr, hr = _tiny_images()
    first = model.infer(lr, hr, cai_mode="m2", process_num=2)
    profiling.enable()
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            warm = model.infer(lr, hr, cai_mode="m2", process_num=2)
    finally:
        profiling.disable()
        profiling.clear()
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]

    def ranges(name):
        return [e.time_range for e in cpu if e.name == name]

    def inside(e, rs):
        return any(r.start <= e.time_range.start
                   and e.time_range.end <= r.end for r in rs)

    # each aten op of the request with the device copies it launched (a
    # runtime event can share a copy's correlation id and list it too)
    copies = [(e, k.name) for e in cpu if e.name.startswith("aten::")
              and inside(e, ranges("pf.request"))
              for k in e.kernels if "Memcpy" in k.name]
    branches = ranges("pf.coarse") + ranges("pf.chunk")
    assert len(ranges("pf.stitch")) == 2 and len(branches) == 6
    uploads = [e for e, name in copies
               if "HtoD" in name and not inside(e, branches)]
    assert len(uploads) == 2 and all(inside(e, ranges("pf.h2d"))
                                     for e in uploads), \
        [(e.name, e.time_range) for e in uploads]
    assert not [name for e, name in copies
                if "DtoD" not in name and inside(e, ranges("pf.stitch"))]
    assert np.array_equal(first, warm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_g2l_forms_its_mask_on_the_card(cuda, dtype):
    """A warm G2LFusion forward at the largest G2L level of a 392x518 tile
    (32 channels, 8 heads, depth 2: one shifted block over 1452 windows),
    under torch.profiler, copies nothing from the host and waits for
    nothing; its output equals the uploaded-mask formula's
    (test_torch_g2l_mask.py), which, profiled alike, does copy."""
    from patchfusion_tpu_torch.models.swin import G2LFusion
    from tests.test_torch_g2l_mask import randomised, uploaded_g2l

    h, w = 392, 518
    mod = randomised(G2LFusion(32, 12, 8, 2, h * w), 0).to(cuda, dtype)
    x = _seeded((1, 32, h, w), dtype, cuda, seed=1)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]

    def profiled(fn):
        with torch.no_grad(), torch.profiler.profile(
                activities=activities) as prof:
            out = fn(x)
        torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        return out, kernels, [e.name for e in prof.events()]

    with torch.no_grad():
        mod(x)      # the first forward builds the label map
    torch.cuda.synchronize()
    got, kernels, names = profiled(mod)
    want, _, old_names = profiled(lambda t: uploaded_g2l(mod, t))
    assert len(kernels) > 20
    assert not [n for n in names if "Memcpy" in n or n.startswith(
        ("cudaMemcpy", "cudaStreamSynchronize"))], sorted(set(names))
    assert any("Memcpy HtoD" in n for n in old_names)
    assert any(n == "cudaStreamSynchronize" or n.startswith("cudaMemcpy")
               for n in old_names)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


# -- the resize kernel (csrc/resize.cu through ops/resize.interpolate) -----
#
# The kernel computes the arithmetic of F.interpolate's NCHW CUDA kernels,
# FMAs where nvcc contracted theirs, so it is held to F.interpolate of a
# contiguous NCHW copy (_bench_util.library_resize) to one unit in the
# last place of the output dtype: an FMA that stood elsewhere would part
# them by far more where the sums cancel. (PyTorch's own channels-last
# bilinear kernel, taken from 16 channels up, contracts otherwise; the
# request's calls, NCHW planes and the bicubic pos-embed, never take it.)
# The share that is bit-equal is printed.

def _held_to_library(x, size, mode, ac, scale, h_axis, w_axis):
    """The kernel's resize of x against the library's; returns the
    bit-equal share."""
    from patchfusion_tpu_torch.ops import resize
    from patchfusion_tpu_torch.tools._bench_util import (library_resize,
                                                         ulp_stats)

    before = dict(resize.LAUNCHES)
    got = resize.interpolate(x, size, mode, ac, scale, h_axis, w_axis)
    want = library_resize(x, size, mode, ac, scale, h_axis, w_axis)
    launched = {k: v - before[k] for k, v in resize.LAUNCHES.items()}
    assert launched == {"resize_bilinear": int(mode == "bilinear"),
                        "resize_bicubic": int(mode == "bicubic")}
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous()
    worst, equal = ulp_stats(got, want)
    assert worst <= 1, (tuple(x.shape), size, mode, ac, scale, worst)
    return equal


def _seeded(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)


@pytest.fixture(scope="module")
def request_resizes():
    """Every bilinear and bicubic interpolate of a full-width DA-vitl and
    DA-vits m1 request (2160x3840, bf16, chunks of 16 tiles), recorded
    through the wrapper: (shape, stride, dtype, mode, align_corners,
    scale, size, h_axis, w_axis) -> calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.ops import resize
    from patchfusion_tpu_torch.tools._bench_util import published_config

    calls = {}
    real = resize.resize_cuda

    def spy(x, size, mode, align_corners, scale, h_axis, w_axis):
        key = (tuple(x.shape), tuple(x.stride()), x.dtype, mode,
               bool(align_corners), scale, tuple(size), h_axis % x.ndim,
               w_axis % x.ndim)
        calls[key] = calls.get(key, 0) + 1
        return real(x, size, mode, align_corners, scale, h_axis, w_axis)

    rng = np.random.default_rng(11)
    hr = rng.random((2160, 3840, 3), dtype=np.float32)
    resize.resize_cuda = spy
    try:
        for core in ("vitl", "vits"):
            model = PatchFusion.from_config(published_config(core),
                                            dtype=torch.bfloat16, seed=0)
            lr = resize.interpolate(
                torch.from_numpy(hr)[None],
                model.tile_cfg.patch_process_shape, mode="bilinear",
                align_corners=True).numpy()
            model.infer(lr, hr, cai_mode="m1", process_num=16)
            del model
            torch.cuda.empty_cache()
    finally:
        resize.resize_cuda = real
    return calls


@pytest.mark.cuda
def test_resize_kernel_at_every_call_of_a_request(cuda, request_resizes):
    """Each shape a vitl and a vits m1 request resizes, on a seeded input
    of that shape and strides, against F.interpolate."""
    # the pos-embed (bicubic, channels last), the DPT, fusion and bins
    # heads' upsamples and the tiles' crop resize
    assert any(k[3] == "bicubic" for k in request_resizes)
    assert len(request_resizes) >= 20
    shares = []
    for (shape, stride, dtype, mode, ac, scale, size, ha, wa) in \
            request_resizes:
        span = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
        x = _seeded((span,), dtype, cuda).as_strided(shape, stride)
        shares.append(_held_to_library(x, size, mode, ac, scale, ha, wa))
        del x
    print(f"resize kernel vs F.interpolate over {len(shares)} request "
          f"shapes: bit-equal share min {min(shares):.6f}, mean "
          f"{np.mean(shares):.6f}")


# the rN count map (the 4K tiles' reensemble canvas to the raw image, f32,
# channels last with one channel) and the BEiT DPT head's upsamples at
# 384x512 tiles, four a chunk (models/beit.py: the refinenets, then x2)
RESIZE_SHAPES = [
    ((1, 1568, 2072, 1), (2160, 3840), torch.float32, -3, -2),
    ((4, 256, 12, 16), (24, 32), torch.bfloat16, -2, -1),
    ((4, 256, 24, 32), (48, 64), torch.bfloat16, -2, -1),
    ((4, 256, 48, 64), (96, 128), torch.bfloat16, -2, -1),
    ((4, 256, 96, 128), (192, 256), torch.bfloat16, -2, -1),
    ((4, 128, 192, 256), (384, 512), torch.bfloat16, -2, -1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,size,dtype,h_axis,w_axis", RESIZE_SHAPES)
def test_resize_kernel_at_rn_and_beit_shapes(cuda, shape, size, dtype,
                                             h_axis, w_axis):
    x = _seeded(shape, dtype, cuda)
    _held_to_library(x, size, "bilinear", True, None, h_axis, w_axis)


# (input shape, size, scale, h_axis, w_axis): 1-pixel axes in and out, a
# downsample, an axis of equal size, both with an explicit scale, channels
# last (vector and scalar channel paths), odd widths across the 16-byte
# store grid
EDGE_CASES = [
    ((3, 2, 1, 1), (5, 7), None, -2, -1),
    ((3, 2, 1, 9), (4, 13), None, -2, -1),
    ((2, 3, 5, 7), (1, 1), None, -2, -1),
    ((2, 3, 5, 7), (1, 9), None, -2, -1),
    ((2, 3, 37, 53), (19, 20), None, -2, -1),
    ((5, 16, 37), (32, 37), None, -2, -1),
    ((1, 37, 37, 64), (28, 37), (28.1 / 37, 37.1 / 37), -3, -2),
    ((1, 37, 37, 64), (37, 37), (37.1 / 37, 37.1 / 37), -3, -2),
    ((2, 9, 11, 24), (17, 23), None, -3, -2),
    ((2, 9, 11, 3), (17, 23), None, -3, -2),
    ((7, 13, 3), (29, 13), None, -2, -1),
    ((5, 19, 37), (31, 3), None, -2, -1),
    ((1, 3, 600, 1001), (391, 517), None, -2, -1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_resize_kernel_edge_cases(cuda, case, dtype, mode, ac):
    shape, size, scale, h_axis, w_axis = case
    x = _seeded(shape, dtype, cuda, seed=len(shape))
    _held_to_library(x, size, mode, ac, scale, h_axis, w_axis)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_resize_kernel_takes_strided_and_unaligned_inputs(cuda, mode):
    """A channels-last view of an NCHW tensor (channel stride not 1), a
    start off the 16-byte grid and a row stride wider than the row: the
    scalar channel path, and the plane path's gathers."""
    x = _seeded((2, 24, 9, 11), torch.bfloat16, cuda).permute(0, 2, 3, 1)
    _held_to_library(x, (17, 23), mode, False, None, -3, -2)
    y = _seeded((2, 9, 11, 25), torch.float32, cuda)[..., 1:]
    _held_to_library(y, (17, 23), mode, True, None, -3, -2)
    z = _seeded((4, 15, 40), torch.bfloat16, cuda)[:, :, 3:34]
    _held_to_library(z, (29, 61), mode, True, None, -2, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    ((2, 4, 14, 19), (28, 37), "bilinear", True, None, -2, -1),
    ((1, 37, 37, 32), (28, 37), "bicubic", False, (28.1 / 37, 37.1 / 37),
     -3, -2)])
def test_resize_gradient_is_the_plain_versions(cuda, dtype, case):
    """Under a gradient the kernel runs in an autograd Function whose
    backward is the plain version's vector-Jacobian product: the same
    gradient as F.interpolate's, up to the order of its backward kernel's
    atomic adds, which in bf16 round each partial sum to bf16 (so two runs
    of that kernel differ by a few bf16 ulps of the largest gradient)."""
    from patchfusion_tpu_torch.ops import resize
    from patchfusion_tpu_torch.tools._bench_util import (library_resize,
                                                         ulp_stats)

    shape, size, mode, ac, scale, ha, wa = case
    x = _seeded(shape, dtype, cuda).requires_grad_()
    before = dict(resize.LAUNCHES)
    y = resize.interpolate(x, size, mode, ac, scale, ha, wa)
    assert resize.LAUNCHES["resize_" + mode] == before["resize_" + mode] + 1
    g = _seeded(y.shape, dtype, cuda, seed=1)
    (got,) = torch.autograd.grad(y, x, g)
    (want,) = torch.autograd.grad(
        resize.interpolate_plain(x, size, mode, ac, scale, ha, wa), x, g)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2 ** -6 * float(want.abs().max()))
    else:
        torch.testing.assert_close(got, want)
    assert ulp_stats(y.detach(), library_resize(
        x.detach(), size, mode, ac, scale, ha, wa))[0] <= 1


@pytest.mark.cuda
def test_resize_kernel_rejects_what_it_does_not_take(cuda):
    from patchfusion_tpu_torch.ops import resize

    with pytest.raises(TypeError):
        resize.interpolate(torch.zeros(2, 3, 4, 5, device=cuda,
                                       dtype=torch.float16), (8, 10),
                           h_axis=-2, w_axis=-1)
    # one row's source rows outgrow a block: pf_resize refuses it
    with pytest.raises(RuntimeError, match="resize kernel launch failed"):
        resize.interpolate(torch.zeros(1, 1, 8, 8, device=cuda), (8, 30000),
                           h_axis=-2, w_axis=-1)
    with pytest.raises(ValueError):  # a scale that gives another size
        resize.interpolate(torch.zeros(1, 8, 8, 4, device=cuda), (5, 5),
                           mode="bicubic", scale=(0.5, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_twins_launch_no_resize_kernel(cuda, dtype):
    """The head kernels' plain twins, which the card tests and chip_smoke
    hold the kernels against, stay plain PyTorch on the card: their
    bilinear resizes (centers and the condition's projection, IHxIW ->
    OHxOW) are interpolate_plain's, and launch no resize kernel."""
    from patchfusion_tpu_torch.ops import resize

    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.random((B, OH, OW), dtype=np.float32) * 0.98
                         + 0.01).to(cuda)
    t = torch.from_numpy(rng.random((B, OH, OW), dtype=np.float32)).to(cuda)
    centers = _nhwc(rng.random((B, IH, IW, K), dtype=np.float32) * 70 + 1,
                    dtype, cuda, "nchw-view")
    last = _nhwc(rng.standard_normal((B, OH, OW, CIN), dtype=np.float32),
                 dtype, cuda, "nchw-view")
    cond = _nhwc(rng.standard_normal((B, IH, IW, CC), dtype=np.float32),
                 dtype, cuda, "nchw-view")
    ws = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.1)
          .to(cuda, dtype) for s in ((CIN + CC, HID), (HID,), (HID, 4),
                                     (4,))]
    before = dict(resize.LAUNCHES)
    fused_head.logbinomial_depth_plain(p, t, centers)
    fused_head.clb_pt_plain(last, cond, *ws)
    fused_head.clb_logbinomial_depth_plain(last, cond, centers, *ws)
    torch.cuda.synchronize()
    assert resize.LAUNCHES == before
    # the same resize through the wrapper is the kernel's
    resize.interpolate(centers.to(torch.float32), (OH, OW),
                       align_corners=True)
    assert resize.LAUNCHES["resize_bilinear"] == \
        before["resize_bilinear"] + 1


@pytest.mark.cuda
def test_request_runs_no_library_resize(cuda):
    """A tiny m2 request on the card launches no upsample kernel of the
    library: every bilinear and bicubic resize is the kernel's, counted in
    LAUNCHES once per call."""
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.ops import resize
    from patchfusion_tpu_torch.tools._bench_util import tiny_config

    model = PatchFusion.from_config(tiny_config(), device="cuda",
                                    dtype=torch.bfloat16, seed=0)
    lr, hr = _tiny_images()
    model.infer(lr, hr, cai_mode="m2", process_num=2)
    calls = {"bilinear": 0, "bicubic": 0}
    real = resize.resize_cuda

    def spy(x, size, mode, *args):
        calls[mode] += 1
        return real(x, size, mode, *args)

    before = dict(resize.LAUNCHES)
    resize.resize_cuda = spy
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            model.infer(lr, hr, cai_mode="m2", process_num=2)
            torch.cuda.synchronize()
    finally:
        resize.resize_cuda = real
    names = {e.key for e in prof.key_averages()}
    assert not [n for n in names if "upsample_bilinear2d" in n
                or "upsample_bicubic2d" in n], names
    assert any("resize_planes" in n for n in names), names
    assert calls["bilinear"] > 0
    assert {m: resize.LAUNCHES["resize_" + m] - before["resize_" + m]
            for m in calls} == calls
