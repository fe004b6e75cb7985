"""The CUDA kernels of patchfusion_tpu_torch against their plain twins, on a
card. Every test here needs CUDA and skips without it. This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up JAX for the rest of the suite).
"""

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
    fused clb_logbinomial_depth runs the same device bodies as clb_pt then
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
