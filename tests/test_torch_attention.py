"""The port's ViT attention (patchfusion_tpu_torch/ops/vit_attention.py and
the PF_ATTN_IMPL dispatch of models/dinov2.py) against the JAX package's
Pallas attention kernels (interpret mode) and einsum attention, on the same
numpy inputs. The CUDA kernel is held against the twin on a card by
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from patchfusion_tpu.engine.inference import PatchFusionInference
from patchfusion_tpu.models import dinov2 as jax_dinov2
from patchfusion_tpu.models.builder import build_patchfusion as jax_build
from patchfusion_tpu.ops import pallas_attention as pa
from patchfusion_tpu_torch.api import PatchFusion
from patchfusion_tpu_torch.models import dinov2
from patchfusion_tpu_torch.ops import vit_attention as va

from .torch_parity import bf16_params, nchw, port_net, rel_err, tiny_jax

torch.set_num_threads(2)

# the JAX attention tests' bound: bf16 inputs and bf16 probabilities
ATTN_ATOL = 2.5e-2
# twin vs the JAX einsum attention, the same function: measured 0, 0 and
# 2.4e-7 on the three shapes (CPU). Another f32 summation order of a logit
# can flip one bf16 rounding, so the bound is one bf16 ulp of outputs below
# 2; the kernels' twin-vs-Pallas differences above reach 7.8e-3
EINSUM_ATOL = 8e-3
# twin (logits in f32, s - m rounded to bf16) vs _attn_kernel_mxsum with
# bf16_exp=True: measured 0 to 9.8e-4 over four seeds of the three shapes
# (CPU), i.e. at most one bf16 rounding of a probability apart. 2e-3 is one
# bf16 ulp of outputs in [0.25, 0.5), about half an ulp of the largest
# outputs here; rounding the logits too (the earlier mapping) is 3.9e-3 to
# 7.8e-3 off and fails it
MXSUM_BF16_EXP_ATOL = 2e-3
# bf16 model outputs, relative to max |value|; measured with
# PF_ATTN_IMPL=pallas on both sides (CPU): DinoViT taps <= 2.1e-2, engine
# m1 1.1e-2 (with the einsum attention: 1.0e-2 and 1.1e-2)
BF16_TOL = 3e-2

# (b, n, h, dh): ragged N as in tests/test_pallas_attention.py, with head
# widths the CUDA kernel takes (multiples of 16)
SHAPES = [(2, 37, 2, 16), (1, 130, 4, 16), (1, 250, 2, 32)]
# JAX kernel -> the twin's rounding (round_logits, round_diff)
JAX_KERNELS = {
    "vit_attention": (lambda q, k, v: pa.vit_attention(q, k, v),
                      (True, True)),
    "blocked_128": (lambda q, k, v: pa.vit_attention_blocked(q, k, v, 128),
                    (False, False)),
    "blocked_64": (lambda q, k, v: pa.vit_attention_blocked(q, k, v, 64),
                   (False, False)),
    "mxsum": (lambda q, k, v: pa.vit_attention_mxsum(q, k, v),
              (False, False)),
    "mxsum_bf16_exp": (lambda q, k, v: pa.vit_attention_mxsum(
        q, k, v, bf16_exp=True), (False, True)),
}


def _qkv(shape, seed=0):
    """bf16-representable float32 q, k, v (the values both sides see)."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
                       np.float32) for _ in range(3)]


def _both(arrays):
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


@pytest.mark.parametrize("kernel", list(JAX_KERNELS))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernels(kernel, shape):
    fn, rounding = JAX_KERNELS[kernel]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jq, jk, jv), np.float32)
    got = va.vit_attention_plain(tq, tk, tv, *rounding)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATTN_ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_rounds_as_mxsum_bf16_exp(shape):
    """round_logits=False, round_diff=True is _attn_kernel_mxsum's
    bf16_exp=True rounding, held to about one bf16 ulp."""
    for seed in (0, 1):
        (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape, seed=seed))
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(pa.vit_attention_mxsum(jq, jk, jv,
                                                     bf16_exp=True),
                              np.float32)
        got = va.vit_attention_plain(tq, tk, tv, round_logits=False,
                                     round_diff=True)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=MXSUM_BF16_EXP_ATOL)
        coarse = va.vit_attention_plain(tq, tk, tv)
        assert np.abs(coarse.float().numpy() - want).max() \
            > MXSUM_BF16_EXP_ATOL


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_is_the_einsum_attention(shape):
    """vit_attention_plain (both roundings on) is the JAX einsum path's function
    and the port's default bf16 attention."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape, seed=1))
    want = np.asarray(jax_dinov2.fused_attention(jq, jk, jv, impl="einsum"),
                      np.float32)
    got = va.vit_attention_plain(tq, tk, tv)
    np.testing.assert_allclose(got.float().numpy(), want, atol=EINSUM_ATOL)
    assert torch.equal(dinov2.fused_attention(tq, tk, tv), got)


def test_wrappers_route_cpu_tensors_to_the_twin(monkeypatch):
    """On CPU tensors the three wrappers and the pallas dispatch return the
    twin's results exactly, never load the kernel library and leave the
    launch count at 0; strided qkv views go in as they are."""
    def no_library():
        raise AssertionError("the kernel library was loaded for CPU input")

    monkeypatch.setattr(va, "load_kernels", no_library)
    monkeypatch.setattr(va, "LAUNCHES", {"vit_attention": 0})
    qkv = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 37, 3, 2, 16)).astype(np.float32)).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    exact = va.vit_attention_plain(q, k, v)
    f32_exp = va.vit_attention_plain(q, k, v, round_logits=False,
                                     round_diff=False)
    f32_logits = va.vit_attention_plain(q, k, v, round_logits=False)
    assert torch.equal(va.vit_attention(q, k, v), exact)
    assert torch.equal(va.vit_attention_mxsum(q, k, v, bf16_exp=True),
                       f32_logits)
    assert torch.equal(va.vit_attention_mxsum(q, k, v), f32_exp)
    assert torch.equal(va.vit_attention_blocked(q, k, v), f32_exp)
    assert torch.equal(dinov2.fused_attention(q, k, v, impl="pallas"), exact)
    monkeypatch.setenv("PF_ATTN_IMPL", "pallas")
    assert torch.equal(dinov2.fused_attention(q, k, v), exact)
    assert va.LAUNCHES == {"vit_attention": 0}
    with pytest.raises(ValueError, match="block_rows"):
        va.vit_attention_blocked(q, k, v, block_rows=0)


def test_float32_attention_ignores_the_variable(monkeypatch):
    """float32 attention is dense whatever PF_ATTN_IMPL says, as in JAX."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 20, 2, 16), seed=3))
    dense = dinov2.fused_attention(q, k, v)
    monkeypatch.setenv("PF_ATTN_IMPL", "pallas")
    assert torch.equal(dinov2.fused_attention(q, k, v), dense)
    want = np.asarray(jax_dinov2.fused_attention(
        *(jnp.asarray(a.numpy()) for a in (q, k, v))))
    np.testing.assert_allclose(dense.numpy(), want, rtol=1e-5, atol=1e-5)


def _generic_interpreter(monkeypatch):
    """Run the JAX package's Pallas kernels in Pallas' generic interpreter
    (interpret=True, as tests/test_pallas_head.py does) for the model-level
    tests: TPU interpret mode keeps one global simulated TPU memory and is
    not safe for several kernels in flight at once, which a jitted model
    program or asynchronous dispatch can give it. The kernel-level tests
    above run one kernel at a time in TPU interpret mode."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(
        *a, **{**k, "interpret": True}))


@pytest.fixture(scope="module")
def tiny():
    cfg, _, _, var = tiny_jax(0)
    net, tile_cfg = port_net(cfg, var, torch.bfloat16)
    return cfg, var, net, tile_cfg


def test_dinovit_pallas_matches_jax(tiny, monkeypatch):
    """The vitmicro DinoViT in bf16 with PF_ATTN_IMPL=pallas on both sides
    (the JAX kernel interpreted, the port's twin on the CPU)."""
    cfg, var, net, _ = tiny
    monkeypatch.setenv("PF_ATTN_IMPL", "pallas")
    _generic_interpreter(monkeypatch)
    image = np.random.default_rng(10).random((2, 42, 56, 3),
                                             dtype=np.float32)
    p = bf16_params(var)["params"]["coarse_branch"]["core"]["pretrained"]
    vit = jax_dinov2.DinoViT(**jax_dinov2.VIT_CONFIGS["vitmicro"],
                             dtype=jnp.bfloat16)
    want = vit.apply({"params": p}, jnp.asarray(image, jnp.bfloat16))
    with torch.no_grad():
        got = net.coarse_branch.core.core.pretrained(
            nchw(image, torch.bfloat16))
    assert len(got) == len(want) == 4
    for (gt, gc), (wt, wc) in zip(got, want):
        assert rel_err(gt.float().numpy(), np.asarray(wt, np.float32)) \
            <= BF16_TOL
        assert rel_err(gc.float().numpy(), np.asarray(wc, np.float32)) \
            <= BF16_TOL


def test_engine_m1_pallas_matches_jax(tiny, monkeypatch):
    """The tiny config's m1 in bf16 with PF_ATTN_IMPL=pallas: the port's
    engine against the JAX engine on the same converted weights."""
    cfg, var, net, tile_cfg = tiny
    monkeypatch.setenv("PF_ATTN_IMPL", "pallas")
    _generic_interpreter(monkeypatch)
    rng = np.random.default_rng(3)
    lr = rng.random((1, 42, 56, 3), dtype=np.float32)
    hr = rng.random((84, 112, 3), dtype=np.float32)
    jnet, jtile_cfg = jax_build(cfg, dtype=jnp.bfloat16)
    engine = PatchFusionInference(jnet, bf16_params(var), jtile_cfg,
                                  process_num=2)
    want = np.asarray(engine.infer(lr, hr, cai_mode="m1"), np.float32)
    got = PatchFusion(net, tile_cfg, cfg).infer(lr, hr, cai_mode="m1",
                                                process_num=2)
    assert got.shape == want.shape
    assert rel_err(got, want) <= BF16_TOL


def test_kernel_wrappers_raise_under_grad(monkeypatch):
    """The attention kernel has no backward (nor has the TPU kernel): a call
    that would carry a gradient raises, naming PF_ATTN_IMPL, on the CPU as
    on the card; without grad mode, or with no input requiring grad, it runs
    (the frozen branches of fusion training)."""
    qkv = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 13, 3, 2, 32)).astype(np.float32)).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].clone().requires_grad_() for i in range(3))
    monkeypatch.setenv("PF_ATTN_IMPL", "pallas")
    for fn in (va.vit_attention, va.vit_attention_blocked,
               va.vit_attention_mxsum, dinov2.fused_attention):
        with pytest.raises(RuntimeError, match="PF_ATTN_IMPL"):
            fn(q, k, v)
        with torch.no_grad():
            assert fn(q, k, v).shape == q.shape
    monkeypatch.setenv("PF_ATTN_IMPL", "einsum")
    out = dinov2.fused_attention(q, k, v)
    out.float().sum().backward()
    assert q.grad is not None and q.grad.dtype == torch.bfloat16
