"""G2L's shifted-window mask formed on the logits' device
(`ops/windows.shifted_window_mask_on`, `models/swin.py`) against the host
mask and the formula that uploaded it, and the counters that say how often
a label map is built. Imports neither JAX nor the JAX package; the JAX
parity of the mask and of G2L is in test_torch_ops.py and
test_torch_models.py."""

import numpy as np
import pytest
import torch

from patchfusion_tpu_torch.models import swin
from patchfusion_tpu_torch.ops import windows
from patchfusion_tpu_torch.utils import profiling

WINDOW, SHIFT = 12, 6
# the six G2L levels of a 392x518 tile (DA-ZoeDepth) and of a 384x512 one
# (BEiT ZoeDepth), and one level that needs no padding
LEVELS = [(392, 518), (224, 296), (112, 148), (56, 74), (28, 37), (14, 19),
          (384, 512), (192, 256), (96, 128), (48, 64), (24, 32), (12, 16),
          (24, 36)]


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


def padded(h, w):
    return -(-h // WINDOW) * WINDOW, -(-w // WINDOW) * WINDOW


def uploaded_window_attention(attn: swin.WindowAttention, x: torch.Tensor,
                              mask: np.ndarray) -> torch.Tensor:
    """WindowAttention.forward as it was: the host mask uploaded at each
    call and folded into a (B * nW, nh, N, N) bias."""
    b_, n, c = x.shape
    nh = attn.num_heads
    qkv = attn.qkv(x).reshape(b_, n, 3, nh, c // nh)
    idx = attn.relative_position_index.reshape(-1)
    bias = attn.relative_position_bias_table[idx].reshape(n, n, nh)
    bias = bias.permute(2, 0, 1).float()[None]
    nw = mask.shape[0]
    m = torch.from_numpy(mask).to(x.device)
    bias = (bias[None] + m[None, :, None]).expand(
        b_ // nw, nw, nh, n, n).reshape(b_, nh, n, n)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() \
        * (c // nh) ** -0.5 + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", probs, v)
    return attn.proj(out.reshape(b_, n, c))


def uploaded_g2l(mod: swin.G2LFusion, x: torch.Tensor) -> torch.Tensor:
    """G2LFusion.forward with every shifted block's attention as it was
    (`uploaded_window_attention`)."""
    def forward(attn):
        def call(xw, mask=None):
            if mask is None:
                return swin.WindowAttention.forward(attn, xw)
            host = windows.shifted_window_mask(*padded(*x.shape[2:]),
                                               WINDOW, SHIFT)
            return uploaded_window_attention(attn, xw, host)
        return call

    blocks = [b.attn for b in mod.g2l_layer.blocks]
    saved = [a.forward for a in blocks]
    try:
        for a in blocks:
            a.forward = forward(a)
        return mod(x)
    finally:
        for a, f in zip(blocks, saved):
            a.forward = f


def randomised(mod: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter redrawn, the bias tables included (zeros at init,
    where the order of the bias and mask adds could not show)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    return mod


@pytest.mark.parametrize("hw", LEVELS)
def test_device_mask_equals_the_host_mask(hw):
    hp, wp = padded(*hw)
    got = windows.shifted_window_mask_on(hp, wp, WINDOW, SHIFT, "cpu")
    want = windows.shifted_window_mask.__wrapped__(hp, wp, WINDOW, SHIFT)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    lab = windows.shifted_window_labels(hp, wp, WINDOW, SHIFT,
                                        torch.device("cpu"))
    assert lab.dtype == torch.uint8 and lab.shape == want.shape[:2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(24, 36), (14, 19)])
def test_window_attention_equals_the_uploaded_mask_formula(hw, dtype):
    """Bitwise, two images of nW windows each: the mask joins after the
    bias, broadcast over images and heads, as the folded bias did."""
    hp, wp = padded(*hw)
    nw = (hp // WINDOW) * (wp // WINDOW)
    attn = randomised(swin.WindowAttention(32, WINDOW, 4), 1).to(dtype)
    x = torch.randn((2 * nw, WINDOW * WINDOW, 32),
                    generator=torch.Generator().manual_seed(2)).to(dtype)
    mask = windows.shifted_window_mask_on(hp, wp, WINDOW, SHIFT, "cpu")
    with torch.no_grad():
        got = attn(x, mask)
        want = uploaded_window_attention(
            attn, x, windows.shifted_window_mask(hp, wp, WINDOW, SHIFT))
        unmasked = attn(x)
    assert torch.equal(got, want)
    assert not torch.equal(got, unmasked)


def test_g2l_counts_label_builds_and_shifted_blocks():
    """A depth-2 G2L (one shifted block) at two levels, the second twice:
    the first request builds one label map per distinct shape and the
    second none; every request counts its three shifted blocks; the output
    is bitwise the uploaded-mask formula's."""
    windows.shifted_window_labels.cache_clear()
    sizes = [(26, 30), (14, 19)]
    mods = [randomised(swin.G2LFusion(16, WINDOW, 2, 2, h * w), 3 + i)
            for i, (h, w) in enumerate(sizes)]
    xs = [torch.randn((1, 16, h, w),
                      generator=torch.Generator().manual_seed(4 + i))
          for i, (h, w) in enumerate(sizes)]
    calls = [(mods[0], xs[0]), (mods[1], xs[1]), (mods[1], xs[1])]
    profiling.enable()
    outs = []
    with torch.no_grad():
        for _ in range(2):
            with profiling.request("cpu"):
                outs.append([m(x) for m, x in calls])
        want = [uploaded_g2l(m, x) for m, x in calls]
    first, second = ({k: n for k, n in r["counters"].items()
                      if k.startswith("g2l_")} for r in profiling.records())
    assert first == {"g2l_mask_builds": 2, "g2l_shift_blocks": 3}
    assert second == {"g2l_shift_blocks": 3}
    for got in outs:
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_g2l_gradients_equal_the_uploaded_mask_formula():
    """Under autograd (training, remat), the device mask takes no gradient
    and the parameters' gradients are the uploaded-mask formula's: bitwise,
    but for the bias tables', which sum over images and windows in another
    order (and, scattered through the index on several threads, differ
    from run to run of one formula): there to 1e-5 of their largest, some
    eighty f32 ulps."""
    mod = randomised(swin.G2LFusion(16, WINDOW, 2, 2, 26 * 30), 5)
    x = torch.randn((2, 16, 26, 30),
                    generator=torch.Generator().manual_seed(6))
    grads = []
    for run in (mod, lambda t: uploaded_g2l(mod, t)):
        mod.zero_grad()
        run(x).square().sum().backward()
        # embed_proj is held for strict loads and takes no gradient
        grads.append({k: p.grad for k, p in mod.named_parameters()
                      if p.grad is not None})
    got, want = grads
    assert got.keys() == want.keys()
    assert len(got) == len(list(mod.parameters())) - 2
    for k in got:
        if k.endswith("relative_position_bias_table"):
            err = (got[k] - want[k]).abs().max()
            assert err <= 1e-5 * want[k].abs().max(), k
        else:
            assert torch.equal(got[k], want[k]), k
