"""The port's metric-bins head ops (patchfusion_tpu_torch/ops/fused_head.py)
against the JAX package's Pallas kernels (interpret mode) and their
*_reference functions, on the same numpy inputs. The CUDA kernels are
held against the twins on a card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchfusion_tpu.models.zoedepth import \
    ConditionalLogBinomial as JaxConditionalLogBinomial
from patchfusion_tpu.ops import pallas_head
from patchfusion_tpu_torch.ops import fused_head

from .torch_parity import bf16_params, nchw, nhwc, port_net, rel_err, \
    tiny_jax

torch.set_num_threads(2)

# (b, oh, ow, ih, iw): the JAX tests' shapes, and a ragged OH (not a
# multiple of 8, so the Pallas kernels cannot tile it; reference only)
SHAPES = {"main": (2, 56, 74, 32, 42), "ragged": (2, 42, 56, 24, 30)}
K, CIN, CC, HID = 64, 33, 128, 80


def _interpret(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)


def _depth_inputs(shape, seed=0):
    b, oh, ow, ih, iw = shape
    rng = np.random.default_rng(seed)
    p = rng.random((b, oh, ow), dtype=np.float32) * 0.98 + 0.01
    t = rng.random((b, oh, ow), dtype=np.float32)
    centers = rng.random((b, ih, iw, K), dtype=np.float32) * 70 + 1
    return p, t, centers


def _clb_inputs(shape, seed=0):
    b, oh, ow, ih, iw = shape
    rng = np.random.default_rng(seed)
    last = rng.random((b, oh, ow, CIN), dtype=np.float32) - 0.5
    cond = rng.random((b, ih, iw, CC), dtype=np.float32) - 0.5
    w1 = (rng.random((CIN + CC, HID), dtype=np.float32) - 0.5) * 0.2
    b1 = rng.random((HID,), dtype=np.float32) - 0.5
    w2 = (rng.random((HID, 4), dtype=np.float32) - 0.5) * 0.2
    b2 = rng.random((4,), dtype=np.float32) - 0.5
    return last, cond, w1, b1, w2, b2


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", ["main", "ragged"])
def test_logbinomial_depth_plain_matches_reference(shape):
    args = _depth_inputs(SHAPES[shape])
    golden = np.asarray(pallas_head.logbinomial_depth_reference(*args))
    out = fused_head.logbinomial_depth_plain(*_t(*args)).numpy()
    np.testing.assert_allclose(out, golden, rtol=1e-4, atol=1e-4)


def test_logbinomial_depth_plain_matches_pallas_kernel(monkeypatch):
    args = _depth_inputs(SHAPES["main"])
    _interpret(monkeypatch)
    kernel = np.asarray(pallas_head.logbinomial_depth(*args, block_rows=8))
    out = fused_head.logbinomial_depth_plain(*_t(*args)).numpy()
    np.testing.assert_allclose(out, kernel, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", ["main", "ragged"])
def test_clb_pt_plain_matches_reference(shape):
    args = _clb_inputs(SHAPES[shape])
    gp, gt = (np.asarray(x) for x in pallas_head.clb_pt_reference(*args))
    p, t = fused_head.clb_pt_plain(*_t(*args))
    np.testing.assert_allclose(p.numpy(), gp, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(t.numpy(), gt, rtol=2e-4, atol=2e-4)


def test_clb_pt_plain_matches_pallas_kernel(monkeypatch):
    args = _clb_inputs(SHAPES["main"])
    _interpret(monkeypatch)
    kp, kt = (np.asarray(x) for x in pallas_head.clb_pt(*args,
                                                        block_rows=8))
    p, t = fused_head.clb_pt_plain(*_t(*args))
    np.testing.assert_allclose(p.numpy(), kp, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(t.numpy(), kt, rtol=2e-4, atol=2e-4)


def _clb_depth_inputs(shape, seed=0):
    """last_cat, cond_lo, centers, w1, b1, w2, b2 (clb_depth_reference's
    argument order)."""
    last, cond, w1, b1, w2, b2 = _clb_inputs(shape, seed)
    centers = _depth_inputs(shape, seed)[2]
    return last, cond, centers, w1, b1, w2, b2


@pytest.mark.parametrize("shape", ["main", "ragged"])
def test_clb_depth_plain_matches_reference(shape):
    args = _clb_depth_inputs(SHAPES[shape])
    golden = np.asarray(pallas_head.clb_depth_reference(*args))
    out = fused_head.clb_logbinomial_depth_plain(*_t(*args)).numpy()
    np.testing.assert_allclose(out, golden, rtol=2e-4, atol=2e-4)


def test_clb_depth_plain_matches_pallas_kernel(monkeypatch):
    args = _clb_depth_inputs(SHAPES["main"])
    _interpret(monkeypatch)
    kernel = np.asarray(pallas_head.clb_logbinomial_depth(*args,
                                                          block_rows=8))
    out = fused_head.clb_logbinomial_depth_plain(*_t(*args)).numpy()
    np.testing.assert_allclose(out, kernel, rtol=2e-4, atol=2e-4)


def test_depth_fused_matches_jax(monkeypatch):
    """ConditionalLogBinomial.depth_fused of the tiny config's PF head in
    bf16, weights converted from JAX, against the JAX module's depth_fused
    (its Pallas kernel in interpret mode). Both compute in f32 from the
    same bf16 inputs (measured 3.5e-7 of max on the CPU), so the bound is
    f32 reassociation, well inside the bf16 contract's 2e-2."""
    cfg, _, _, var = tiny_jax(0)
    net, _ = port_net(cfg, var, torch.bfloat16)
    clb = net.conditional_log_binomial
    last, cond, centers = _clb_depth_inputs(SHAPES["main"], seed=4)[:3]
    jclb = JaxConditionalLogBinomial(
        CIN, CC, K, clb.min_temp, clb.max_temp, dtype=jnp.bfloat16)
    params = bf16_params(var)["params"]["head"]["conditional_log_binomial"]
    _interpret(monkeypatch)
    want = jclb.apply({"params": params},
                      *(jnp.asarray(a, jnp.bfloat16)
                        for a in (last, cond, centers)),
                      8, method=JaxConditionalLogBinomial.depth_fused)
    with torch.no_grad():
        got = clb.depth_fused(*(nchw(a, torch.bfloat16)
                                for a in (last, cond, centers)))
    assert got.dtype == torch.float32
    assert rel_err(nhwc(got), want) <= 1e-4
    with pytest.raises(TypeError, match="bf16-only"):
        clb.float().depth_fused(*(nchw(a) for a in (last, cond, centers)))


def test_wrappers_route_cpu_tensors_to_the_twins(monkeypatch):
    """On CPU tensors the wrappers return the plain twins' results exactly,
    never touch the kernel library and leave the launch counts at 0; the
    NCHW-permuted views the model passes give the same results."""
    def no_library():
        raise AssertionError("the kernel library was loaded for CPU input")

    zero = {"clb_pt": 0, "logbinomial_depth": 0, "clb_logbinomial_depth": 0}
    monkeypatch.setattr(fused_head, "load_kernels", no_library)
    monkeypatch.setattr(fused_head, "LAUNCHES", dict(zero))
    p, t, centers = _t(*_depth_inputs(SHAPES["main"]))
    d = fused_head.logbinomial_depth(p, t, centers)
    assert torch.equal(d, fused_head.logbinomial_depth_plain(p, t, centers))
    view = centers.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    torch.testing.assert_close(fused_head.logbinomial_depth(p, t, view), d)

    args = _t(*_clb_inputs(SHAPES["main"]))
    got = fused_head.clb_pt(*args)
    for a, b in zip(got, fused_head.clb_pt_plain(*args)):
        assert torch.equal(a, b)

    args = _t(*_clb_depth_inputs(SHAPES["main"]))
    d = fused_head.clb_logbinomial_depth(*args)
    assert torch.equal(d, fused_head.clb_logbinomial_depth_plain(*args))
    views = [a.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
             for a in args[:3]]
    torch.testing.assert_close(
        fused_head.clb_logbinomial_depth(*views, *args[3:]), d)
    assert fused_head.LAUNCHES == zero


def test_wrappers_reject_mixed_devices():
    p, t, centers = _t(*_depth_inputs(SHAPES["main"]))
    with pytest.raises(ValueError, match="several devices"):
        fused_head.logbinomial_depth(p, t, centers.to("meta"))


@pytest.mark.parametrize("k", [64, 100, 300])
def test_c0_table_matches_jax_and_is_made_once(k):
    """The depth kernels' c0 table (the wrapper's, cached per bin count and
    device) is the JAX package's log-binomial coefficients, bit for bit."""
    table = fused_head._c0_table(k, torch.device("cpu"))
    assert table.dtype == torch.float32 and table.shape == (k,)
    np.testing.assert_array_equal(table.numpy(),
                                  pallas_head._log_binom_coeffs(k))
    assert fused_head._c0_table(k, torch.device("cpu")) is table


# -- gradients: the recompute backward against the JAX custom VJPs ---------

def _jax_vjp(fn, args, cotangent):
    """The JAX function's VJP at args for the numpy cotangent(s)."""
    import jax
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return out, [np.asarray(g) for g in vjp(cotangent)]


# (port wrapper, JAX function, input builder, differentiable argument count)
GRAD_CASES = {
    "logbinomial_depth": (
        fused_head.logbinomial_depth, fused_head.logbinomial_depth_plain,
        lambda *a: pallas_head.logbinomial_depth(*a, block_rows=8),
        _depth_inputs),
    "clb_pt": (
        fused_head.clb_pt, fused_head.clb_pt_plain,
        lambda *a: pallas_head.clb_pt(*a, block_rows=8), _clb_inputs),
    "clb_logbinomial_depth": (
        fused_head.clb_logbinomial_depth,
        fused_head.clb_logbinomial_depth_plain,
        lambda *a: pallas_head.clb_logbinomial_depth(*a, block_rows=8),
        _clb_depth_inputs),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_recompute_backward_matches_jax_custom_vjp(name, monkeypatch):
    """Each wrapper on CPU tensors that require grad goes through
    Recompute (forward: the twin, as the kernel on the card; backward: the
    twin recomputed under autograd). Its gradients for every input against
    the JAX function's custom VJP (the Pallas kernel's forward in
    interpret mode, the *_reference VJP backward) for the same seeded
    cotangent: within 1e-4 of each gradient's max (both f32; the two
    backward graphs differ by float reassociation, measured <= 1.7e-5)."""
    wrapper, _, jax_fn, inputs = GRAD_CASES[name]
    args = inputs(SHAPES["main"], seed=3)
    _interpret(monkeypatch)
    rng = np.random.default_rng(9)
    out_shape = args[0].shape[:3]
    n_out = 2 if name == "clb_pt" else 1
    cot = [rng.standard_normal(out_shape).astype(np.float32)
           for _ in range(n_out)]
    _, want = _jax_vjp(jax_fn, args,
                       tuple(jnp.asarray(c) for c in cot) if n_out == 2
                       else jnp.asarray(cot[0]))
    calls = []
    monkeypatch.setattr(fused_head.Recompute, "backward",
                        _counting(fused_head.Recompute.backward, calls))
    xs = [x.requires_grad_() for x in _t(*args)]
    out = wrapper(*xs)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cot])
    assert calls == [1]
    assert len(want) == len(xs)
    for x, w in zip(xs, want):
        assert x.grad.shape == x.shape and x.grad.dtype == x.dtype
        assert rel_err(x.grad.numpy(), w) <= 1e-4


def _counting(fn, calls):
    def wrapped(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    return staticmethod(wrapped)


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_recompute_takes_the_forward_it_is_given(name):
    """Recompute runs the forward it is handed (the kernel route on the
    card; here a spy around the twin) exactly once, and recomputes the
    plain twin in the backward, whose gradients equal plain autograd's
    through the twin. Views of NCHW tensors in bf16, as the model passes
    them, get gradients of the view's shape in bf16."""
    _, plain, _, inputs = GRAD_CASES[name]
    args = inputs(SHAPES["ragged"], seed=5)
    ran = []

    def spy(*a, **k):
        ran.append(1)
        return plain(*a, **k)

    def leaves():
        out = []
        for a in _t(*args):
            if a.dim() == 4:
                nchw_t = a.permute(0, 3, 1, 2).contiguous().to(
                    torch.bfloat16).requires_grad_()
                out.append((nchw_t, nchw_t.permute(0, 2, 3, 1)))
            else:
                a.requires_grad_()
                out.append((a, a))
        return out

    kw = {} if name == "clb_pt" else {"min_temp": 0.0212, "max_temp": 50.0}
    if name != "logbinomial_depth":
        kw["p_eps"] = 1e-4
    got_leaves = leaves()
    out = fused_head.Recompute.apply(spy, plain, kw,
                                     *(v for _, v in got_leaves))
    assert ran == [1]
    want_leaves = leaves()
    ref = plain(*(v for _, v in want_leaves), **kw)
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    sum(o.sum() for o in out).backward()
    sum(r.sum() for r in ref).backward()
    assert ran == [1]
    for (g, _), (w, _) in zip(got_leaves, want_leaves):
        assert g.grad.shape == g.shape and g.grad.dtype == g.dtype
        assert torch.equal(g.grad, w.grad)


def test_no_grad_calls_skip_the_function(monkeypatch):
    """Without grad mode, or with no input that requires grad, the wrappers
    run their forward directly: Recompute is not entered (so inference
    launches each kernel as before, counts unchanged)."""
    def refuse(*a, **k):
        raise AssertionError("Recompute entered")

    monkeypatch.setattr(fused_head.Recompute, "apply", refuse)
    for name, (wrapper, _, _, inputs) in GRAD_CASES.items():
        xs = _t(*inputs(SHAPES["main"]))
        wrapper(*xs)
        with torch.no_grad():
            wrapper(*(x.requires_grad_() for x in xs))
