"""The port's training path (patchfusion_tpu_torch: models/losses.py,
engine/training.py, the train-mode loader's rotation) against the JAX
package on the CPU, in float32, on the tiny config with the same seeded
weights (tests/torch_parity.py::tiny_jax through convert/from_jax.py) and
the same numpy inputs.

The JAX train step is built once for the file (a module-scoped fixture
that jits one loss-and-gradient function and reuses it for three
optimizer steps); the bf16 --amp reference lives in
tests/test_torch_trainer.py, so that the two compile on different
workers."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from patchfusion_tpu.data import transforms as jax_transforms
from patchfusion_tpu.engine import training as jtrain
from patchfusion_tpu.models.losses import SILogLoss as JaxSILogLoss
from patchfusion_tpu.models.patchfusion import PatchFusionNet as JaxNet
from patchfusion_tpu_torch.data import transforms
from patchfusion_tpu_torch.engine import training
from patchfusion_tpu_torch.models.losses import SILogLoss

from .torch_parity import (by_port_name, nchw, port_net, rel_err, tiny_jax,
                           train_batch)

torch.set_num_threads(2)

MIN_D, MAX_D = 1e-3, 80.0
TOTAL_STEPS = 7  # a schedule short enough that three steps see its rise


@pytest.fixture(scope="module")
def ref():
    """The JAX f32 step on the tiny config: losses, gradients, BN stats and
    parameters over three optimizer steps of a 7-step schedule.

    flax's BatchNorm takes the batch variance as E[x^2] - E[x]^2
    (use_fast_variance), torch's in two passes. On this net the fast form
    loses enough digits to move the U-Net's gradients by up to 1.3e-3 of
    their max (measured), more than the two frameworks' other rounding
    differences. So the reference is traced with flax's own two-pass
    variance (use_fast_variance=False): the same batch statistics, taken as
    torch takes them; the update rule (momentum 0.9, biased variance) is
    flax's either way."""
    import flax.linen.normalization as flax_norm

    compute_stats = flax_norm._compute_stats

    def two_pass(*a, **k):
        return compute_stats(*a, **{**k, "use_fast_variance": False})

    flax_norm._compute_stats = two_pass
    try:
        return _jax_steps()
    finally:
        flax_norm._compute_stats = compute_stats


def _jax_steps():
    cfg, jnet, _, var = tiny_jax(0)
    batch = {k: jnp.asarray(v) for k, v in train_batch().items()}
    sig = JaxSILogLoss()
    trainable, frozen = jtrain.split_params(var["params"])

    @jax.jit
    def loss_and_grads(trainable, stats):
        def loss_of(tr):
            pred, mutated = jnet.apply(
                {"params": jtrain.merge_params(tr, frozen),
                 "batch_stats": stats}, batch["image_lr"],
                batch["crops_image_hr"], batch["bboxs"], train=True,
                mutable=["batch_stats"], method=JaxNet.train_forward)
            return sig(pred, batch["crop_depths"], MIN_D, MAX_D), \
                mutated["batch_stats"]
        (loss, new_stats), grads = jax.value_and_grad(
            loss_of, has_aux=True)(trainable)
        return loss, new_stats, grads

    tx = jtrain.make_onecycle_optimizer(1e-4, TOTAL_STEPS)
    opt = tx.init(trainable)
    stats = var["batch_stats"]
    steps = []
    for _ in range(3):
        loss, stats, grads = loss_and_grads(trainable, stats)
        updates, opt = tx.update(grads, opt, trainable)
        trainable = optax.apply_updates(trainable, updates)
        steps.append({"loss": float(loss), "grads": grads, "stats": stats,
                      "params": trainable})
    return cfg, var, steps


def _port_state(cfg, var):
    net, _ = port_net(cfg, var)
    tx = training.make_onecycle_optimizer(1e-4, TOTAL_STEPS)
    return training.create_train_state(net, tx)


def _port_batch():
    batch = train_batch()
    return training.to_device_batch(batch, "cpu", batch.keys())


# the U-Net encoder, whose BatchNorms normalise over few values at its
# lowest levels (4 crops x 1 x 1 at the bottom): in f32 its gradients are
# only good to ~1e-4 of their max in either framework (the port's f32
# gradients there differ from its own float64 ones by up to 1.0e-4, and
# from the JAX package's by up to 3.1e-4; measured), so they are held to
# 1e-3, the rest to 1e-4
ENCODER = ("guided_fusion.inc.", "guided_fusion.down_conv_list.")


def test_fusion_step_matches_jax(ref):
    """One f32 fusion step: the loss within 1e-5 relative, each trainable
    gradient within 1e-4 of that tensor's max (the U-Net encoder's within
    1e-3, see ENCODER), the BN running statistics after the step within
    1e-5 of each tensor's max (flax's update rule: momentum 0.9, biased
    variance)."""
    cfg, var, steps = ref
    state = _port_state(cfg, var)
    loss, _ = training.fusion_loss(state, _port_batch(), SILogLoss(), MIN_D,
                                   MAX_D)
    want = steps[0]
    assert abs(float(loss) - want["loss"]) <= 1e-5 * abs(want["loss"])
    jgrads = by_port_name(want["grads"], var, cfg)
    for name, p in state.trainable.items():
        if not np.any(jgrads[name]):
            # unread by the loss (the sixth fusion conv; G2L's dead
            # projection, which the JAX tree lacks): a zero gradient, so
            # that AdamW decays it as optax does
            assert not p.grad.any(), name
            continue
        tol = 1e-3 if name.startswith(ENCODER) else 1e-4
        assert rel_err(p.grad.numpy(), jgrads[name]) <= tol, name
    jstats = by_port_name(want["params"], var, cfg, want["stats"])
    bn = {k: v for k, v in state.batch_stats.items()
          if not k.endswith("num_batches_tracked")}
    assert bn
    for name, buf in bn.items():
        assert rel_err(buf.numpy(), jstats[name]) <= 1e-5, name


def test_three_steps_match_jax(ref):
    """Three optimizer steps (clip 0.1, AdamW, the 7-step OneCycle lr and
    b1): each step's loss within 1e-5 relative, and the trainable
    parameters' movement from their start against the JAX step's: within
    1e-2 in L2 over all of them (measured 4.4e-3), and within 0.1 for each
    tensor the loss reaches (measured <= 5.8e-2). Adam moves a weight by
    about lr times the sign of its averaged gradient, so where the
    gradient's f32 noise (the encoder's, see ENCODER) flips a small
    component, that weight steps the other way; a wrong lr, b1, clip or
    decay moves every tensor by O(1). The tensors the loss does not reach
    only decay, by ~1e-8 per step, at their float rounding."""
    cfg, var, steps = ref
    state = _port_state(cfg, var)
    start = {k: v.detach().clone() for k, v in state.trainable.items()}
    step = training.make_train_step(min_depth=MIN_D, max_depth=MAX_D)
    batch = _port_batch()
    for want in steps:
        logs = step(state, batch)
        assert abs(float(logs["total_loss"]) - want["loss"]) <= \
            1e-5 * abs(want["loss"])
    assert state.step == 3
    jstart = by_port_name(jtrain.split_params(var["params"])[0], var, cfg)
    jend = by_port_name(steps[-1]["params"], var, cfg)
    jgrads = by_port_name(steps[0]["grads"], var, cfg)
    diff2 = ref2 = 0.0
    for name, p in state.trainable.items():
        moved = (p.detach() - start[name]).numpy().astype(np.float64)
        jmoved = (jend[name] - jstart[name]).astype(np.float64)
        diff2 += ((moved - jmoved) ** 2).sum()
        ref2 += (jmoved ** 2).sum()
        if np.any(jgrads[name]):
            assert np.linalg.norm(moved - jmoved) <= \
                0.1 * np.linalg.norm(jmoved), name
    assert np.sqrt(diff2 / ref2) <= 1e-2


@pytest.mark.parametrize("total", [7, 100])
def test_schedule_matches_optax(total):
    """lr and b1 of every step against optax's injected hyperparameters
    (the state after each update holds the values that update used): lr
    within 1e-6 of the peak (optax computes in float32), b1 within 1e-6."""
    tx = jtrain.make_onecycle_optimizer(1e-4, total)
    params = {"w": jnp.ones(3)}
    state = tx.init(params)
    ours = training.make_onecycle_optimizer(1e-4, total)
    for i in range(total + 2):
        _, state = tx.update({"w": jnp.ones(3)}, state, params)
        hp = state[1].hyperparams
        assert abs(float(hp["learning_rate"]) - ours.lr(i)) <= 1e-10, i
        assert abs(float(hp["b1"]) - ours.b1(i)) <= 1e-6, i


def test_clip_and_adamw_match_optax():
    """One update of a small tree with a gradient norm above the clip:
    optax's chain (clip_by_global_norm, adamw through
    inject_hyperparams) against OneCycleAdamW.update, within 1e-6 of
    each parameter's max; the returned norm is the unclipped one."""
    rng = np.random.default_rng(4)
    w = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    g = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for total in (3, 1):
        tx = jtrain.make_onecycle_optimizer(1e-2, total)
        jp = {"a": jnp.asarray(w[0]), "b": jnp.asarray(w[1])}
        state = tx.init(jp)
        ours = training.make_onecycle_optimizer(1e-2, total)
        tp = [torch.from_numpy(x.copy()).requires_grad_() for x in w]
        opt = ours.init(tp)
        for i in range(2):
            upd, state = tx.update({"a": jnp.asarray(g[0]),
                                    "b": jnp.asarray(g[1])}, state, jp)
            jp = optax.apply_updates(jp, upd)
            for p, x in zip(tp, g):
                p.grad = torch.from_numpy(x.copy())
            norm = ours.update(opt, tp, i)
            assert abs(float(norm) - np.sqrt(sum((x ** 2).sum()
                                                 for x in g))) <= 1e-5
        for p, k in zip(tp, "ab"):
            assert rel_err(p.detach().numpy(), jp[k]) <= 1e-6


def _silog_inputs(seed, shape=(2, 1, 24, 30), target_shape=None):
    rng = np.random.default_rng(seed)
    pred = rng.random(shape, dtype=np.float32) * 30 + 0.5
    # depths in [0, 90): 0 (no GT) and beyond max_depth are masked out
    tgt = rng.random(target_shape or shape, dtype=np.float32) * 90
    tgt[..., :2, :] = 0.0
    return pred, tgt


@pytest.mark.parametrize("case", ["plain", "resize", "mask", "fallback",
                                  "one_pixel", "bf16"])
def test_silog_matches_jax(case):
    """SILogLoss against the JAX SILogLoss, and its gradient against
    jax.grad of it (both f32: within 1e-5 relative; the bf16 pred is
    rounded the same way on both sides first). resize: the pred
    bilinear-resized (align_corners) to the target; mask: an
    additional_mask covering enough pixels; fallback: one covering fewer
    than 0.1% (the plain validity mask is used); one_pixel: fewer than 2
    valid pixels give 0 with a zero gradient."""
    pred, tgt = _silog_inputs(
        1, target_shape=(2, 1, 48, 60) if case == "resize" else None)
    mask = None
    if case in ("mask", "fallback"):
        mask = np.zeros(tgt.shape, bool)
        if case == "mask":
            mask[:, :, ::2] = True
        else:
            mask[0, 0, 0, 0] = True
    if case == "one_pixel":
        tgt = np.zeros(tgt.shape, np.float32)
        tgt[0, 0, 3, 3] = 10.0
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    pt = torch.from_numpy(pred).to(dtype).requires_grad_()
    got = SILogLoss()(pt, torch.from_numpy(tgt), MIN_D, MAX_D,
                      None if mask is None else torch.from_numpy(mask))
    got.backward()
    jdtype = jnp.bfloat16 if case == "bf16" else jnp.float32

    def jloss(p):
        return JaxSILogLoss()(
            p, jnp.asarray(np.moveaxis(tgt, 1, -1)), MIN_D, MAX_D,
            None if mask is None else jnp.asarray(np.moveaxis(mask, 1, -1)))

    want, jgrad = jax.value_and_grad(jloss)(
        jnp.asarray(np.moveaxis(pred, 1, -1), jdtype))
    got = got.detach()
    assert abs(float(got) - float(want)) <= 1e-5 * max(abs(float(want)),
                                                       1e-6)
    jgrad = np.moveaxis(np.asarray(jgrad, np.float32), -1, 1)
    if case == "one_pixel":
        assert float(got) == 0.0 and not pt.grad.float().any()
        assert not jgrad.any()
    else:
        assert rel_err(pt.grad.float().numpy(), jgrad) <= 1e-5


@pytest.mark.parametrize("shape", [(84, 112), (540, 960)])
def test_aug_rotate_matches_cv2(shape):
    """The port's OpenCV-free rotation against the JAX package's cv2 one,
    from the same rng: the same angle is drawn (the rngs stay in step);
    the uint8 image within 1 level everywhere (cv2 quantises its bilinear
    weights to 1/32 of a pixel; measured 1 level at <= 0.5% of pixels of
    a noise image) and 2 levels in the bound; the float GT maps equal
    except at <= 0.1% of pixels, where a nearest pick falls on a
    half-pixel tie (measured <= 1.3e-4 at 4K)."""
    h, w = shape
    rng = np.random.default_rng(2)
    image = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    depth = (rng.random((h, w)) * 70 + 1).astype(np.float32)
    disp = (50.0 / depth).astype(np.float32)
    r_port, r_jax = np.random.default_rng(7), np.random.default_rng(7)
    got_i, got_g = transforms.aug_rotate(image, [depth, disp], 1.0, r_port)
    want_i, want_g = jax_transforms.aug_rotate(image, [depth, disp], 1.0,
                                               r_jax)
    assert r_port.random() == r_jax.random()
    assert got_i.dtype == np.uint8 and got_i.shape == image.shape
    diff = np.abs(got_i.astype(int) - want_i.astype(int))
    assert diff.max() <= 2 and (diff > 0).mean() <= 0.01
    for g, wg in zip(got_g, want_g):
        assert g.dtype == np.float32 and g.shape == (h, w)
        assert (g != wg).mean() <= 1e-3
    # the matrix is cv2's
    mat = transforms.rotation_matrix(((w - 1) / 2, (h - 1) / 2), 0.7)
    np.testing.assert_allclose(
        mat, cv2.getRotationMatrix2D(((w - 1) / 2, (h - 1) / 2), 0.7, 1.0),
        atol=1e-12)


def test_train_loader_runs_without_cv2(monkeypatch, tmp_path):
    """The port's train-mode U4K item with OpenCV made unimportable: the
    rotation runs in scipy."""
    import builtins
    import chip_smoke
    from patchfusion_tpu_torch.data.u4k import UnrealStereo4kDataset

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2" or name.startswith("cv2."):
            raise ImportError("cv2 is not installed")
        return real_import(name, *a, **k)

    split = chip_smoke.write_u4k_split(tmp_path, 1, (84, 112))
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    ds = UnrealStereo4kDataset(
        "train", str(tmp_path), split,
        dict(network_process_size=[42, 56], degree=1.0), MIN_D, MAX_D,
        patch_raw_shape=(42, 56), resize_mode="depth-anything")
    item = ds[0]
    assert item["crops_image_hr"].shape == (42, 56, 3)
    assert np.isfinite(item["crops_image_hr"]).all()
    assert item["crop_depths"].shape == (42, 56, 1)
    assert nchw(item["crop_depths"][None]).shape == (1, 1, 42, 56)
