"""The port's research losses (patchfusion_tpu_torch/models/losses.py)
against the JAX package's on the same numpy inputs, f32 on both sides:
losses within rtol 1e-5, the gradients with respect to the prediction
within 1e-4 of their max against jax.grad, the incoherence labels equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchfusion_tpu.models import losses as jl
from patchfusion_tpu_torch.config.registry import MODELS
from patchfusion_tpu_torch.models import losses as tl

from .torch_parity import nchw, nhwc

torch.set_num_threads(2)

RTOL = 1e-5
GRAD_TOL = 1e-4  # relative to the gradient's max
MIN_DEPTH, MAX_DEPTH = 1e-3, 80.0


def _close_grad(got: torch.Tensor, want) -> None:
    """The port's NCHW gradient against JAX's NHWC one, where JAX's is
    finite; the port's is finite everywhere (the Sobel magnitude's NaN at
    0, losses._sobel_grad_map)."""
    got = nhwc(got)
    want = np.asarray(want)
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max()
    assert np.isfinite(got).all() and scale > 0 and fin.mean() > 0.5
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=GRAD_TOL * scale)


def _depth(rng, shape, zeros=True, far=True):
    """(B, H, W, 1) depths in (1, 60) with zeros (label 2), values beyond
    max_depth (2) and beyond 10000 (3) where asked."""
    d = (rng.random(shape, dtype=np.float32) * 59 + 1)
    if zeros:
        d[0, :3, :4] = 0.0
    if far:
        d[-1, -2:, -5:] = 500.0
        d[-1, -1, :3] = 20000.0
    return d


def _probs(rng, shape, n_classes):
    logits = rng.standard_normal((*shape, n_classes)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_sobel_grad_map_matches_jax(rng):
    x = rng.random((2, 11, 13, 1), dtype=np.float32) * 10
    got = tl._sobel_grad_map(nchw(x))
    want = jl._sobel_grad_map(jnp.asarray(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("use_grad,use_value",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_incoherent_mask_matches_jax(rng, use_grad, use_value):
    """gt with zeros (the gradient error's 0 / 0 and x / 0) and labels 2 and
    3; the coarse prediction at a lower size."""
    gt = _depth(rng, (2, 24, 32, 1))
    coarse = rng.random((2, 12, 16, 1), dtype=np.float32) * 50 + 1
    want = np.asarray(jl.get_incoherent_mask(
        jnp.asarray(gt), shape=(12, 16), min_depth=MIN_DEPTH,
        max_depth=MAX_DEPTH, coarse_prediction=jnp.asarray(coarse),
        use_grad=use_grad, use_value=use_value))
    got = tl.get_incoherent_mask(
        nchw(gt), shape=(12, 16), min_depth=MIN_DEPTH, max_depth=MAX_DEPTH,
        coarse_prediction=nchw(coarse), use_grad=use_grad,
        use_value=use_value)
    assert got.shape == (2, 24, 32) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) >= {0, 2, 3}


@pytest.mark.parametrize("loss_type", ["incoh", "incoh+grad",
                                       "incoh+grad+depth"])
def test_error_loss_matches_jax(rng, loss_type):
    """Two classes, labels 2 and 3 among the targets (one-hot rows of
    zeros, as jax.nn.one_hot gives), probs at half the target's size."""
    probs = _probs(rng, (2, 12, 16), 2)
    gt = _depth(rng, (2, 24, 32, 1))
    coarse = rng.random((2, 12, 16, 1), dtype=np.float32) * 50 + 1
    jloss = jl.ErrorLoss(loss_type=loss_type, focal_weight=0.3)
    tloss = tl.ErrorLoss(loss_type=loss_type, focal_weight=0.3)

    def jfn(p):
        dice, focal, mask = jloss(p, jnp.asarray(gt), jnp.asarray(coarse),
                                  MIN_DEPTH, MAX_DEPTH)
        return dice + focal, (dice, focal, mask)

    jgrad, (jdice, jfocal, jmask) = jax.grad(jfn, has_aux=True)(
        jnp.asarray(probs))
    p = nchw(probs).requires_grad_()
    dice, focal, mask = tloss(p, nchw(gt), nchw(coarse), MIN_DEPTH,
                              MAX_DEPTH)
    (dice + focal).backward()
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert {2, 3} <= set(np.unique(mask.numpy()))
    np.testing.assert_allclose(dice.item(), float(jdice), rtol=RTOL)
    np.testing.assert_allclose(focal.item(), float(jfocal), rtol=RTOL)
    _close_grad(p.grad, jgrad)


def test_edge_cls_loss_matches_jax(rng):
    probs = _probs(rng, (2, 10, 14), 3)
    target = rng.integers(0, 3, (2, 20, 28))
    jloss, tloss = jl.EdgeClsLoss(focal_weight=0.7), tl.EdgeClsLoss(0.7)

    def jfn(p):
        dice, focal = jloss(p, jnp.asarray(target))
        return dice + focal, (dice, focal)

    jgrad, (jdice, jfocal) = jax.grad(jfn, has_aux=True)(jnp.asarray(probs))
    p = nchw(probs).requires_grad_()
    dice, focal = tloss(p, torch.from_numpy(target))
    (dice + focal).backward()
    np.testing.assert_allclose(dice.item(), float(jdice), rtol=RTOL)
    np.testing.assert_allclose(focal.item(), float(jfocal), rtol=RTOL)
    _close_grad(p.grad, jgrad)


def _ranking_inputs(rng, b=2, h=24, w=32, missing=False):
    """(inputs at h x w, targets / images / depth_gt at 2x the size: the
    loss resizes them)."""
    inputs = rng.random((b, h, w, 1), dtype=np.float32) * 10 + 0.5
    targets = rng.random((b, 2 * h, 2 * w, 1), dtype=np.float32) * 10 + 0.5
    targets[0, :4, :4] = 80.0  # the reference's strict mask drops 80
    images = rng.random((b, 2 * h, 2 * w, 3), dtype=np.float32)
    gt = rng.random((b, 2 * h, 2 * w, 1), dtype=np.float32) * 70 + 1
    if missing:
        gt[:, 10:30, 20:50] = -99.0
    return inputs, targets, images, gt


@pytest.mark.parametrize("random_direct", [True, False])
@pytest.mark.parametrize("reweight_target", [False, True])
@pytest.mark.parametrize("only_missing_area", [False, True])
def test_ranking_loss_injected_matches_jax(rng, random_direct,
                                           reweight_target,
                                           only_missing_area):
    """The same injected anchors, distances and coins on both sides (one
    image walks along theta, the other its rotation)."""
    inputs, targets, images, gt = _ranking_inputs(
        rng, missing=only_missing_area)
    b, h, w, _ = inputs.shape
    n = 64
    anchor_rc = np.stack([rng.integers(0, h, (b, n)),
                          rng.integers(0, w, (b, n))], -1)
    dist = rng.integers(2, 31, (b, 4, n))
    direct_p = np.array([0.2, 0.8], np.float32)
    kw = dict(point_pairs=n, reweight_target=reweight_target,
              only_missing_area=only_missing_area,
              random_direct=random_direct)
    jloss = jl.EdgeguidedRankingLoss(**kw)

    def jfn(x):
        return jloss(x, jnp.asarray(targets), jnp.asarray(images),
                     jnp.asarray(gt), anchor_rc=jnp.asarray(anchor_rc),
                     dist=jnp.asarray(dist), direct_p=jnp.asarray(direct_p))

    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(inputs))
    x = nchw(inputs).requires_grad_()
    got = tl.EdgeguidedRankingLoss(**kw)(
        x, nchw(targets), nchw(images), nchw(gt),
        anchor_rc=torch.from_numpy(anchor_rc), dist=torch.from_numpy(dist),
        direct_p=torch.from_numpy(direct_p))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    _close_grad(x.grad, jgrad)


def test_ranking_loss_injected_needs_the_coin(rng):
    inputs, targets, images, gt = _ranking_inputs(rng)
    with pytest.raises(ValueError, match="direct_p"):
        tl.EdgeguidedRankingLoss(point_pairs=4)(
            nchw(inputs), nchw(targets), nchw(images), nchw(gt),
            anchor_rc=torch.zeros(2, 4, 2, dtype=torch.long),
            dist=torch.full((2, 4, 4), 2))
    with pytest.raises(ValueError, match="Generator"):
        tl.EdgeguidedRankingLoss(point_pairs=4)(
            nchw(inputs), nchw(targets), nchw(images), nchw(gt))


def test_ranking_loss_generator_draws(rng):
    """Anchors only on the allowed pixels, distances in [2, 30], the coin
    in [0, 1); the same seed gives the same loss, and the drawn samples
    injected give it too."""
    inputs, targets, images, gt = _ranking_inputs(rng)
    loss = tl.EdgeguidedRankingLoss(point_pairs=500)
    args = [nchw(inputs), nchw(targets), nchw(images), nchw(gt)]
    small = [tl.interpolate_nchw(a, (24, 32), align_corners=True)
             for a in args[1:]]
    ok, _ = loss.anchor_mask(*small)
    assert 0 < ok.sum() < ok.numel()
    anchor_rc, dist, direct_p = loss.sample(
        ok, torch.Generator().manual_seed(3))
    assert ok[torch.arange(2)[:, None], anchor_rc[..., 0],
              anchor_rc[..., 1]].all()
    assert dist.min() >= 2 and dist.max() <= 30
    assert set(dist.unique().tolist()) == set(range(2, 31))
    assert ((direct_p >= 0) & (direct_p < 1)).all()
    a = loss(*args, generator=torch.Generator().manual_seed(3))
    b = loss(*args, generator=torch.Generator().manual_seed(3))
    c = loss(*args, generator=torch.Generator().manual_seed(4))
    injected = loss(*args, anchor_rc=anchor_rc, dist=dist,
                    direct_p=direct_p)
    assert a.item() == b.item() == injected.item()
    assert np.isfinite(c.item()) and c.item() != a.item()


@pytest.mark.parametrize("case", ["edgeless", "no_anchor"])
def test_ranking_loss_without_edges_does_not_raise(rng, case):
    """A flat image (no edges: every valid pixel may anchor) and an image
    with no allowed anchor at all (only_missing_area without a missing
    pixel: the draw falls back to every pixel, as the JAX package's
    categorical over all-masked logits does, where torch.multinomial over
    zero weights would raise)."""
    inputs, targets, images, gt = _ranking_inputs(rng)
    images[:] = 0.5
    loss = tl.EdgeguidedRankingLoss(point_pairs=200,
                                    only_missing_area=case == "no_anchor")
    args = [nchw(inputs), nchw(targets), nchw(images), nchw(gt)]
    got = loss(*args, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(got.item())
    if case == "no_anchor":
        ok = torch.zeros(2, 24, 32, dtype=torch.bool)
        anchor_rc, _, _ = loss.sample(ok, torch.Generator().manual_seed(0))
        assert len(torch.unique(anchor_rc[0, :, 0] * 32
                                + anchor_rc[0, :, 1])) > 100


def test_ssi_loss_matches_jax(rng):
    pred = rng.random((3, 12, 16, 1), dtype=np.float32) * 3
    target = rng.random((3, 12, 16, 1), dtype=np.float32) * 5 + 1
    mask = rng.random((3, 12, 16, 1)) > 0.2
    jloss = jl.ScaleAndShiftInvariantLoss()
    want, jgrad = jax.value_and_grad(
        lambda p: jloss(p, jnp.asarray(target), jnp.asarray(mask)))(
        jnp.asarray(pred))
    p = nchw(pred).requires_grad_()
    got = tl.ScaleAndShiftInvariantLoss()(p, nchw(target),
                                          nchw(mask).bool())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    _close_grad(p.grad, jgrad)
    # an image without a valid pixel: det = 0, scale and shift 0, its
    # residual over max(count, 1)
    mask[1] = False
    want = jloss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    got = tl.ScaleAndShiftInvariantLoss()(nchw(pred), nchw(target),
                                          nchw(mask).bool())
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_exist_loss_matches_jax(rng):
    """Over the Sobel magnitudes of a prediction and a coarse one, as the
    research recipe takes them, with an empty mask as the guard's case."""
    pred = rng.random((2, 16, 20, 1), dtype=np.float32) * 10
    coarse = rng.random((2, 16, 20, 1), dtype=np.float32) * 10
    mask = rng.random((2, 16, 20, 1)) > 0.5
    jloss = jl.ExistLoss()

    def jfn(p):
        return jloss(jl._sobel_grad_map(p),
                     jl._sobel_grad_map(jnp.asarray(coarse)),
                     jnp.asarray(mask))

    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pred))
    p = nchw(pred).requires_grad_()
    got = tl.ExistLoss()(tl._sobel_grad_map(p),
                         tl._sobel_grad_map(nchw(coarse)),
                         nchw(mask).bool())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    # JAX's gradient is NaN around a corner (the Sobel magnitude's sqrt at
    # 0), the port's finite
    assert np.isnan(np.asarray(jgrad)).any()
    _close_grad(p.grad, jgrad)
    empty = torch.zeros(2, 1, 16, 20, dtype=torch.bool)
    assert tl.ExistLoss()(nchw(pred), nchw(coarse), empty).item() == 0.0


@pytest.mark.parametrize("name", ["SILogLoss", "EdgeClsLoss", "ErrorLoss",
                                  "EdgeguidedRankingLoss",
                                  "ScaleAndShiftInvariantLoss",
                                  "ExistLoss"])
def test_losses_build_from_the_registry(name):
    """Each class by its config name, with the JAX package's keywords
    (unknown ones ignored, as there)."""
    loss = MODELS.build(dict(type=name, focal_weight=0.25, point_pairs=7,
                             loss_type="incoh+grad", unused=1))
    assert isinstance(loss, getattr(tl, name))
    assert type(loss).__name__ == type(jl.__dict__[name]()).__name__
