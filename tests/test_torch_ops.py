"""The port's ops (resize, roi_align, stitch, masks, windows) against their
patchfusion_tpu.ops counterparts on the same numpy inputs, float32, at
1e-5 unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchfusion_tpu.ops import masks as jmasks
from patchfusion_tpu.ops import resize as jresize
from patchfusion_tpu.ops import roi_align as jroi
from patchfusion_tpu.ops import stitch as jstitch
from patchfusion_tpu.ops import windows as jwin
from patchfusion_tpu_torch.ops import masks, resize, roi_align, stitch
from patchfusion_tpu_torch.ops import windows

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode,align,in_hw,out_hw,scale", [
    ("bilinear", True, (7, 9), (16, 20), None),     # in-model upsample
    ("bilinear", True, (28, 37), (14, 19), None),   # downsample
    ("bilinear", False, (12, 10), (29, 17), None),  # eval resize
    ("bicubic", False, (37, 37), (28, 37), (28.1 / 37, 37.1 / 37)),
    ("bicubic", False, (37, 37), (3, 4), (3.1 / 37, 4.1 / 37)),
    ("nearest", False, (42, 56), (84, 112), None),  # rN average map
    ("nearest", False, (30, 23), (13, 50), None),
])
def test_interpolate_matches_jax(mode, align, in_hw, out_hw, scale):
    x = np.random.default_rng(0).standard_normal(
        (2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jresize.interpolate(
        jnp.asarray(x), out_hw, mode=mode, align_corners=align, scale=scale))
    got = resize.interpolate(torch.from_numpy(x), out_hw, mode=mode,
                             align_corners=align, scale=scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)


RESIZE_CASES = [
    ("bilinear", True, (7, 9), (16, 20), None),
    ("bilinear", True, (28, 37), (14, 19), None),
    ("bilinear", False, (12, 10), (29, 17), None),
    ("bicubic", False, (37, 37), (28, 37), (28.1 / 37, 37.1 / 37)),
    ("bicubic", False, (37, 37), (3, 4), (3.1 / 37, 4.1 / 37)),
]


@pytest.mark.parametrize("mode,align,in_hw,out_hw,scale", RESIZE_CASES)
def test_cpu_interpolate_is_the_plain_version(monkeypatch, mode, align,
                                              in_hw, out_hw, scale):
    """On the CPU a bilinear or bicubic interpolate is the plain version
    (F.interpolate), bit for bit, and launches no kernel."""
    monkeypatch.setattr(resize, "LAUNCHES",
                        {"resize_bilinear": 0, "resize_bicubic": 0})
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, *in_hw, 3)).astype(np.float32))
    got = resize.interpolate(x, out_hw, mode=mode, align_corners=align,
                             scale=scale)
    want = resize.interpolate_plain(x, out_hw, mode=mode,
                                    align_corners=align, scale=scale)
    assert torch.equal(got, want)
    assert resize.LAUNCHES == {"resize_bilinear": 0, "resize_bicubic": 0}


@pytest.mark.parametrize("mode,align,in_hw,out_hw,scale", RESIZE_CASES)
def test_resize_function_backward_is_the_plain_vjp(monkeypatch, mode, align,
                                                   in_hw, out_hw, scale):
    """The kernel's autograd Function, with its forward stood in for by
    the plain version on the CPU: its backward gives F.interpolate's
    gradient exactly (the same vector-Jacobian product, recomputed)."""
    monkeypatch.setattr(resize, "resize_cuda", resize.interpolate_plain)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(
        (2, *in_hw, 3)).astype(np.float32)).requires_grad_()
    y = resize._ResizeFunction.apply(x, out_hw, mode, align, scale, -3, -2)
    g = torch.from_numpy(rng.standard_normal(tuple(y.shape))
                         .astype(np.float32))
    (got,) = torch.autograd.grad(y, x, g)
    (want,) = torch.autograd.grad(resize.interpolate_plain(
        x, out_hw, mode=mode, align_corners=align, scale=scale), x, g)
    assert torch.equal(got, want)


def test_resize_kernel_route_rejects_before_any_launch():
    """The kernel route's checks raise before the library is loaded: a
    dtype it does not take, a mode it has not, a scale that gives another
    size."""
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(TypeError):
        resize.resize_cuda(x.half(), (16, 16), "bilinear", True, None, -3,
                           -2)
    with pytest.raises(ValueError):
        resize.resize_cuda(x, (16, 16), "nearest", False, None, -3, -2)
    with pytest.raises(ValueError):
        resize.resize_cuda(x, (5, 5), "bicubic", False, (0.5, 0.5), -3, -2)


# 84 -> 100, where F.interpolate's float32 scale picks another row (75),
# the shipped rN ratios (reensemble -> raw for vitl/vitb 4K tiles, the
# BEiT family's, and a tile's process -> raw size), and a small grid
NEAREST_SIZES = ([(84, 100), (1568, 2160), (2072, 3840), (1536, 2160),
                  (2048, 3840), (392, 540), (518, 960)]
                 + [(i, o) for i in (3, 7, 13, 42) for o in (5, 11, 50, 97)])


@pytest.mark.parametrize("in_size,out_size", NEAREST_SIZES)
def test_nearest_matches_jax_exactly(in_size, out_size):
    """The port's nearest reads the JAX package's source rows and columns:
    its index equals resize_matrix's, and interpolate gives the same
    array, exactly."""
    want_idx = jresize.resize_matrix(out_size, in_size, "nearest").argmax(1)
    got_idx = resize.nearest_index(out_size, in_size).numpy()
    np.testing.assert_array_equal(got_idx, want_idx)
    x = np.random.default_rng(in_size).standard_normal(
        (1, in_size, 3, 2)).astype(np.float32)
    want = np.asarray(jresize.interpolate(jnp.asarray(x), (out_size, 5),
                                          mode="nearest"))
    got = resize.interpolate(torch.from_numpy(x), (out_size, 5),
                             mode="nearest").numpy()
    np.testing.assert_array_equal(got, want)


def test_nearest_parts_from_f_interpolate_at_84_to_100():
    """The row where F.interpolate's float32 rule and the exact one part."""
    x = torch.arange(84.0).reshape(1, 1, 84, 1)
    torch_rule = torch.nn.functional.interpolate(x, size=(100, 1),
                                                 mode="nearest")
    got = resize.interpolate_nchw(x, (100, 1), mode="nearest")
    assert (got != torch_rule).nonzero()[:, 2].tolist() == [75]
    assert got[0, 0, 75, 0].item() == 63.0


def test_host_resize_matrices_match_jax():
    """The numpy resize_matrix the metrics use is the JAX package's."""
    for args in [(29, 12, "bilinear", False), (16, 7, "bilinear", True),
                 (28, 37, "bicubic", True), (100, 84, "nearest", False)]:
        np.testing.assert_array_equal(resize.resize_matrix(*args),
                                      jresize.resize_matrix(*args))


def test_interpolate_nchw_axes():
    x = torch.randn(2, 3, 7, 9)
    got = resize.interpolate_nchw(x, (16, 20), align_corners=True)
    want = resize.interpolate(x.movedim(1, -1), (16, 20),
                              align_corners=True).movedim(-1, 1)
    torch.testing.assert_close(got, want)


def test_net_resizer_matches_jax():
    for args in [(518, 392, False, 14, "minimal"),
                 (512, 384, True, 32, "minimal"),
                 (518, 392, True, 14, "lower_bound"),
                 (518, 392, True, 14, "upper_bound")]:
        a = jresize.NetResizer(*args)
        b = resize.NetResizer(*args)
        for hw in [(2160, 3840), (480, 640), (1000, 333)]:
            assert a.get_size(*hw) == b.get_size(*hw)


def _boxes(n_side, raw, ps, rng):
    """Process-space boxes of tiles at random raw origins (the engine's
    rN boxes) plus the regular grid."""
    th, tw = raw[0] // n_side, raw[1] // n_side
    ys = rng.integers(0, raw[0] - th, 5)
    xs = rng.integers(0, raw[1] - tw, 5)
    grid = [(y, x) for y in range(0, raw[0], th) for x in range(0, raw[1],
                                                                tw)]
    o = np.array(list(zip(ys, xs)) + grid, np.float32)
    boxes = np.stack([o[:, 1], o[:, 0], o[:, 1] + tw, o[:, 0] + th], 1)
    f = np.array([ps[1] / raw[1], ps[0] / raw[0]] * 2, np.float32)
    return (boxes * f).astype(np.float32)


@pytest.mark.parametrize("hw", [(42, 56), (12, 16), (3, 4)])
def test_roi_align_single_matches_jax(hw):
    """The pyramid levels of the tiny config, with the reference's single
    spatial scale (h / process height) for both axes."""
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((1, *hw, 5)).astype(np.float32)
    boxes = _boxes(2, (84, 112), (42, 56), rng)
    scale = hw[0] / 42
    want = np.asarray(jroi.roi_align_single(
        jnp.asarray(feat), jnp.asarray(boxes), hw[0], hw[1], scale,
        sampling_ratio=1))
    got = roi_align.roi_align_single(
        torch.from_numpy(feat), torch.from_numpy(boxes), hw[0], hw[1],
        scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_roi_align_batched_matches_jax():
    rng = np.random.default_rng(2)
    boxes = _boxes(2, (84, 112), (42, 56), rng)
    feat = rng.standard_normal((len(boxes), 24, 32, 4)).astype(np.float32)
    want = np.asarray(jroi.roi_align_batched(
        jnp.asarray(feat), jnp.asarray(boxes), 24, 32, 24 / 42,
        sampling_ratio=1))
    got = roi_align.roi_align_batched(
        torch.from_numpy(feat), torch.from_numpy(boxes), 24, 32,
        24 / 42).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fn", ["roi_align_single", "roi_align_batched"])
@pytest.mark.parametrize("ratio", [None, 0, -1])
def test_roi_align_rejects_other_sampling_ratios(fn, ratio):
    """No grid count (None: the JAX package asks for a static one) and
    counts below 1 raise; ratios >= 1 are held against JAX in
    tests/test_torch_surface.py."""
    with pytest.raises(ValueError):
        getattr(roi_align, fn)(torch.zeros(1, 4, 4, 1), torch.zeros(1, 4),
                               4, 4, 1.0, sampling_ratio=ratio)


def test_avg_map_matches_jax():
    rng = np.random.default_rng(3)
    pred, cnt, pred2, cnt2 = (rng.random((42, 56), dtype=np.float32) + 0.1
                              for _ in range(4))
    ja = jstitch.AvgMap.init(jnp.asarray(pred), jnp.asarray(cnt)).update(
        jnp.asarray(pred2), jnp.asarray(cnt2)).resize((84, 112))
    ta = stitch.AvgMap.init(torch.from_numpy(pred),
                            torch.from_numpy(cnt)).update(
        torch.from_numpy(pred2), torch.from_numpy(cnt2)).resize((84, 112))
    np.testing.assert_allclose(ta.average.numpy(), np.asarray(ja.average),
                               **TOL)
    np.testing.assert_allclose(ta.count.numpy(), np.asarray(ja.count), **TOL)


def test_paste_grid_matches_jax():
    tiles = np.random.default_rng(4).random((6, 5, 7), dtype=np.float32)
    oh, ow = [2, 7], [3, 10, 17]
    want = np.asarray(jstitch.paste_grid(jnp.asarray(tiles), oh, ow,
                                         (14, 26)))
    got = stitch.paste_grid(torch.from_numpy(tiles), oh, ow, (14, 26))
    np.testing.assert_array_equal(got.numpy(), want)


def test_paste_dynamic_matches_jax():
    rng = np.random.default_rng(5)
    tiles = rng.random((6, 5, 7), dtype=np.float32)
    origins = np.stack([rng.integers(0, 10, 6), rng.integers(0, 20, 6)],
                       1).astype(np.int32)
    origins[1] = origins[0]  # an exact overlap sums
    want = np.asarray(jstitch.paste_dynamic(
        jnp.asarray(tiles), jnp.asarray(origins), (14, 26)))
    got = stitch.paste_dynamic(torch.from_numpy(tiles), origins, (14, 26))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("size", [(42, 56), (392, 518), (540, 960)])
def test_blend_mask_equal(size):
    np.testing.assert_array_equal(masks.blend_mask(size),
                                  jmasks.blend_mask(size))


@pytest.mark.parametrize("hw,shift", [((24, 36), 0), ((14, 19), 6)])
def test_windows_match_jax(hw, shift):
    x = np.random.default_rng(6).standard_normal(
        (2, *hw, 3)).astype(np.float32)
    jx, hp, wp = jwin.pad_to_multiple(jnp.asarray(x), 12)
    tx, thp, twp = windows.pad_to_multiple(torch.from_numpy(x), 12)
    assert (hp, wp) == (thp, twp)
    jw = jwin.window_partition(jx, 12)
    tw = windows.window_partition(tx, 12)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(
        windows.window_reverse(tw, 12, hp, wp).numpy(), np.asarray(jx))
    if shift:
        np.testing.assert_array_equal(
            windows.shifted_window_mask(hp, wp, 12, shift),
            jwin.shifted_window_mask(hp, wp, 12, shift))
