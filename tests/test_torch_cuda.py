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


def _qkv(rng, b, n, h, dh, dev):
    """q, k, v as the model hands them: views qkv[:, :, i] of the qkv
    linear's (B, N, 3, H, Dh) output."""
    qkv = torch.from_numpy(rng.standard_normal(
        (b, n, 3, h, dh), dtype=np.float32)).to(dev, torch.bfloat16)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_exp", [True, False])
@pytest.mark.parametrize("n,dh", [(37, 64), (130, 32), (250, 128),
                                  (1037, 64)])
def test_attention_kernel_matches_twin(cuda, n, dh, bf16_exp):
    """Ragged N (not a multiple of the 64-row tiles), strided qkv views, one
    launch per call. The kernel rounds P to bf16 against its running max,
    the twin against the whole-row max, and they sum in another order:
    1e-2 absolute on outputs of |o| < ~1."""
    q, k, v = _qkv(np.random.default_rng(n), 2, n, 3, dh, cuda)
    before = vit_attention.LAUNCHES["vit_attention"]
    if bf16_exp:
        got = vit_attention.vit_attention(q, k, v)
    else:
        got = vit_attention.vit_attention_mxsum(q, k, v, bf16_exp=False)
    ref = vit_attention.vit_attention_plain(q, k, v, bf16_exp)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous()
    assert (got.float() - ref.float()).abs().max().item() <= 1e-2
    assert vit_attention.LAUNCHES["vit_attention"] == before + 1
    blocked = vit_attention.vit_attention_blocked(q, k, v, block_rows=128)
    ref = vit_attention.vit_attention_plain(q, k, v, bf16_exp=False)
    assert (blocked.float() - ref.float()).abs().max().item() <= 1e-2


@pytest.mark.cuda
def test_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(np.random.default_rng(0), 1, 20, 2, 64, cuda)
    with pytest.raises(TypeError):
        vit_attention.vit_attention(q.float(), k.float(), v.float())
    q72, k72, v72 = _qkv(np.random.default_rng(0), 1, 20, 2, 72, cuda)
    with pytest.raises(ValueError):
        vit_attention.vit_attention(q72, k72, v72)
    wide = torch.zeros(1, 20, 2, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # Dh not contiguous
        vit_attention.vit_attention(q, k, wide[..., ::2])
