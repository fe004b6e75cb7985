"""The port's stage profilers (patchfusion_tpu_torch/tools/profile_*.py and
_bench_util.py) on the CPU at the tiny config, one iteration: each prints
the JAX tool's row names with finite times; the FLOP count of a tiny
DinoViT is the analytic count under both attention paths; the head kernel
wrappers are credited their analytic FLOPs; a share of the peak over 100%
raises; the p49 projection's arithmetic; the stage functions that
profile_infer and profile_stitch time give the JAX methods' and the JAX
stitch chain's outputs (f32, within 1e-5 of max)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from patchfusion_tpu.models.patchfusion import PatchFusionNet as JaxNet
from patchfusion_tpu.models.patchfusion import TileConfig as JaxTileConfig
from patchfusion_tpu.ops import masks as jmasks
from patchfusion_tpu.ops import stitch as jstitch
from patchfusion_tpu_torch.engine.inference import stitch_passes
from patchfusion_tpu_torch.models.dinov2 import build_dinovit
from patchfusion_tpu_torch.models.patchfusion import (TileConfig,
                                                      regular_passes)
from patchfusion_tpu_torch.ops import fused_head
from patchfusion_tpu_torch.tools import (_bench_util, clb_depth_split,
                                         profile_attn, profile_clb,
                                         profile_compile, profile_fine,
                                         profile_infer, profile_stages,
                                         profile_stitch, profile_train,
                                         profile_trunk)

from .torch_parity import nchw, nhwc, port_net, rel_err, tiny_jax

torch.set_num_threads(2)

CPU = "cpu"
TINY_SHAPE = (42, 56)
PROFILERS = (profile_attn, profile_clb, profile_compile, profile_fine,
             profile_infer, profile_stages, profile_stitch, profile_train,
             profile_trunk, clb_depth_split)


def _names(out):
    assert out["device"] == CPU and out["card"] is None
    assert out["torch"] == torch.__version__
    for row in out["rows"]:
        assert np.isfinite(row["ms"]), row
        if "gflop" in row:
            assert row["gflop"] > 0 and np.isfinite(row["tflops"]), row
    return [row["name"].strip() for row in out["rows"]]


# -- each profiler's rows -----------------------------------------------------

def test_profile_infer_rows():
    out = profile_infer.profile(chip_smoke.tiny_config(), chunk=2,
                                dtype=torch.float32, iters=1, device=CPU)
    assert _names(out) == ["coarse+g2l", "chunk[2]", "per tile", "fine[2]",
                           "p49 projection"]
    rows = {r["name"]: r for r in out["rows"]}
    assert rows["per tile"]["gflop"] == pytest.approx(
        rows["chunk[2]"]["gflop"] / 2)
    assert rows["p49 projection"]["chunks"] == 25


def test_profile_stages_and_fine_rows():
    branch = chip_smoke.tiny_config()["fine_branch"]
    out = profile_stages.profile(branch, [1, 2], torch.bfloat16, 1, CPU,
                                 TINY_SHAPE)
    assert _names(out) == ["vit trunk", "vit+dpt", "fine zoe branch",
                           "-> dpt-head part", "bins-head part"] * 2
    out = profile_fine.profile(branch, 1, torch.bfloat16, 1, CPU,
                               shape=TINY_SHAPE)
    assert _names(out) == [
        "vit trunk(4 taps)", "vit+dpt", "fine zoe full", "-> dpt decoder",
        "-> bins head", "dpt head (isolated)", "reassemble+rn",
        "refinenet chain", "output stage", "conv f->f/2 @224x296",
        "upsample f/2 ->full", "conv f/2->32 @full", "relu+1x1 conv @full",
        "up+convs tail", "bins head (isolated)", "seed+attractors",
        "clb+logbinom (fused)"]
    out = profile_fine.profile(branch, 1, torch.float32, 1, CPU,
                               stages="head,clb", shape=TINY_SHAPE)
    assert _names(out) == ["dpt head (isolated)", "clb+logbinom (fused)"]


def test_profile_trunk_rows():
    out = profile_trunk.profile("vitmicro", 1, 1, CPU, TINY_SHAPE)
    names = _names(out)
    assert names[:11] == [
        "timer overhead (id x3)", "timer overhead (id h3)", "qkv 2d",
        "qkv 3d", "proj 2d", "fc1 2d", "fc2 2d", "fc2 3d",
        "layernorm (b,n,d)", "gelu (b,n,4d)", "residual+layerscale"]
    assert names[11:] == [
        "attention einsum", "attention kernel", "attention sdpa",
        "per-layer linear+elementwise floor",
        "trunk floor [einsum attention]", "trunk floor [kernel attention]"]
    rows = {r["name"]: r for r in out["rows"]}
    floor = rows["per-layer linear+elementwise floor"]["ms"]
    assert rows["trunk floor [einsum attention]"]["ms"] == pytest.approx(
        4 * (floor + rows["attention einsum"]["ms"]))
    # qkv: 2 B N D 3D at B = 1, N = 3 x 4 + 1, D = 64
    assert rows["qkv 2d"]["gflop"] == pytest.approx(2 * 13 * 64 * 192 / 1e9)


def test_profile_stitch_rows():
    tc = TileConfig((84, 112), (2, 2), TINY_SHAPE)
    out = profile_stitch.profile(tc, 1, CPU)
    assert out["pass_tiles"] == [4, 2, 2, 1]
    assert _names(out) == ["full 4-pass stitch chain",
                           "single 4-tile paste pass",
                           "chunk-output concat (8+1)"]
    out = profile_stitch.main(["--device", CPU])
    assert out["pass_tiles"] == [16, 12, 12, 9]
    assert _names(out)[1:] == ["single 16-tile paste pass",
                               "chunk-output concat (48+1)"]


@pytest.mark.parametrize("remat,amp", [(False, True), (True, False)])
def test_profile_train_rows(remat, amp):
    out = profile_train.profile(chip_smoke.tiny_config(), 2, 1, remat, amp,
                                CPU)
    tag = "b2 vitmicro" + (" remat" if remat else "") + (" amp" if amp
                                                         else "")
    assert _names(out) == ["first step", f"train step ({tag})"]
    step = out["rows"][1]
    assert step["tflop"] > 0 and step["peak_gib"] is None
    assert np.isfinite(out["rows"][0]["loss"])
    # the first step, the counted one, device_time's warm-up and 1 timed
    assert out["state_step"] == 4


def test_profile_attn_rows(capsys):
    out = profile_attn.main(["--batch", "1", "--n", "13", "--heads", "2",
                             "--dh", "32", "--inner", "1", "--blocks",
                             "128", "--device", CPU])
    assert "--blocks does not apply" in capsys.readouterr().out
    assert _names(out) == ["einsum (bf16 probs)", "sdpa", "pallas whole-row",
                           "pallas blocked", "pallas mxsum",
                           "pallas mxsum bf16exp"]
    assert all(r["rel_err"] <= 2e-2 for r in out["rows"])
    assert out["rows"][0]["gflop"] == pytest.approx(4 * 2 * 13 * 13 * 32
                                                    / 1e9)


def test_profile_clb_rows():
    shape = (42, 56, 24, 32, 64, 33, 128, 80)
    out = profile_clb.profile(2, 1, False, CPU, shape)
    assert _names(out) == [
        "clb pre (proj+gelu+mlp2)", "pallas logbinom kernel",
        "clb full stage", "clb_pt FUSED kernel", "clb full (pt+logbinom)",
        "clb DEEP-FUSED kernel"]
    rows = {r["name"]: r for r in out["rows"]}
    # on the CPU each wrapper is its plain twin: no error
    assert rows["clb_pt FUSED kernel"]["p_err"] == 0
    assert rows["clb DEEP-FUSED kernel"]["rel_err"] == 0
    out = profile_clb.profile(1, 1, True, CPU, shape)
    assert len(out["rows"]) == 3


def test_profile_compile_rows():
    out = profile_compile.profile(chip_smoke.tiny_config(), ["m1", "r2"], 2,
                                  torch.float32, cold=False, iters=1,
                                  device=CPU)
    assert _names(out) == ["model build + seeded init", "m1 first request",
                           "m1 warm request", "r2 first request",
                           "r2 warm request"]
    assert [r.get("tiles") for r in out["rows"][1:]] == [4, 4, 11, 11]
    with pytest.raises(ValueError, match="--no-cold"):
        profile_compile.profile(chip_smoke.tiny_config(), ["m1"], 2,
                                torch.float32, cold=True, device=CPU)


def test_profilers_need_the_card_unless_told_otherwise():
    """--device defaults to cuda: at their defaults the profilers run on
    the card, and without one they raise before any work."""
    if torch.cuda.is_available():
        return
    for mod in PROFILERS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main([])


def test_clb_depth_split_runs_on_the_card_only():
    """The phase split is a timing build's clock64 stamps: there is no
    CPU form of it, so asked for the CPU it refuses before any work."""
    with pytest.raises(SystemExit, match="CUDA card only"):
        clb_depth_split.profile(batch=1, device=CPU)
    with pytest.raises(SystemExit, match="CUDA card only"):
        clb_depth_split.main(["--beit", "--device", CPU])


def test_no_profiler_carries_a_tpu_figure():
    """The JAX tools' TPU constants (v5e's 197 TFLOP/s, a hard-coded
    3.184 ms attention floor) stay out of the port's profilers."""
    for mod in PROFILERS + (_bench_util,):
        src = inspect.getsource(mod)
        for word in ("197", "3.184", "v5e", "MFU"):
            assert word not in src, (mod.__name__, word)


# -- the FLOP count, the peak guard, the projection ---------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_count_flops_of_a_dinovit_is_analytic(dtype, impl, monkeypatch):
    """24 B N D^2 L + 4 B N^2 D L + the patch embedding's 2 B (N - 1) D
    3 p^2, exactly, whatever PF_ATTN_IMPL says: count_flops counts the
    einsum path under either setting, so the two cases agree by
    construction and show that the caller's setting does not leak into
    the count."""
    monkeypatch.setenv("PF_ATTN_IMPL", impl)
    net = build_dinovit("vitmicro", dtype=dtype, device=CPU)
    x = torch.rand(2, 3, *TINY_SHAPE, dtype=dtype)
    with torch.no_grad():
        got = _bench_util.count_flops(net, x)
    assert got == _bench_util.dinovit_flops(2, 13, 64, 4, 3 * 14 * 14)
    assert _bench_util.dinovit_flops(1, 1037, 1024, 24) == pytest.approx(
        7.32e11, rel=1e-3)


def test_count_flops_credits_the_head_kernels():
    """A head wrapper counts its analytic MLP FLOPs, not its plain twin's
    ops, and the wrappers are restored after the count."""
    b, oh, ow, ih, iw, cin, cc, hid = 2, 12, 16, 6, 8, 33, 128, 80
    last = torch.rand(b, oh, ow, cin)
    cond = torch.rand(b, ih, iw, cc)
    cent = torch.rand(b, ih, iw, 64) + 0.1
    ws = [torch.rand(cin + cc, hid), torch.rand(hid), torch.rand(hid, 4),
          torch.rand(4)]
    mlp = _bench_util.clb_mlp_flops(b, oh, ow, ih, iw, cin, cc, hid)
    wrappers = (fused_head.clb_pt, fused_head.logbinomial_depth,
                fused_head.clb_logbinomial_depth)
    with torch.no_grad():
        assert _bench_util.count_flops(
            lambda: fused_head.clb_pt(last, cond, *ws)) == mlp
        assert _bench_util.count_flops(
            lambda: fused_head.logbinomial_depth(
                *fused_head.clb_pt(last, cond, *ws), cent)) == mlp
        assert _bench_util.count_flops(
            lambda: fused_head.clb_logbinomial_depth(last, cond, cent,
                                                     *ws)) == mlp
    assert (fused_head.clb_pt, fused_head.logbinomial_depth,
            fused_head.clb_logbinomial_depth) == wrappers


@pytest.mark.parametrize("kernel", ["clb_pt", "logbinomial_depth_pixel",
                                    "vit_attention"])
def test_count_flops_raises_on_an_uncredited_launch(kernel, monkeypatch):
    """A kernel launch under the count that no credited wrapper made (a
    head wrapper bound by another name, an attention kernel past the
    einsum switch) raises instead of dropping out of the count."""
    from patchfusion_tpu_torch.ops import vit_attention

    counts = vit_attention.LAUNCHES if kernel == "vit_attention" \
        else fused_head.LAUNCHES
    monkeypatch.setitem(counts, kernel, counts[kernel])

    def launch():
        counts[kernel] += 1

    with pytest.raises(RuntimeError, match="credited"):
        _bench_util.count_flops(launch)
    assert _bench_util.count_flops(lambda: None) == 0


def test_count_flops_credits_a_head_call_stopped_after_its_kernel(
        monkeypatch):
    """A remat recompute stops by raising from inside a head wrapper once
    its kernel has run (here a stand-in that the counter cannot see, as it
    cannot see the kernel); the call is credited all the same."""
    b, oh, ow, ih, iw, cin, cc, hid = 1, 6, 8, 3, 4, 33, 128, 80
    args = (torch.rand(b, oh, ow, cin), torch.rand(b, ih, iw, cc),
            torch.rand(cin + cc, hid), torch.rand(hid), torch.rand(hid, 4),
            torch.rand(4))
    class Stop(Exception):
        pass

    def stopped(*a, **kw):
        raise Stop

    def recompute():
        try:
            fused_head.clb_pt(*args)
        except Stop:
            pass

    monkeypatch.setattr(fused_head, "clb_pt", stopped)
    with torch.no_grad():
        assert _bench_util.count_flops(recompute) == \
            _bench_util.clb_mlp_flops(b, oh, ow, ih, iw, cin, cc, hid)


def test_over_peak_share_raises(monkeypatch):
    assert _bench_util.peak_share(4.945e11, 1e-3, 989e12) == \
        pytest.approx(0.5)
    with pytest.raises(RuntimeError, match="fence is broken"):
        _bench_util.peak_share(1e12, 1e-3, 989e12)
    with pytest.raises(RuntimeError, match="fence is broken"):
        _bench_util.stage_row("x", 1e-3, 2e12, _bench_util.BF16_TC_FLOPS)
    cuda = torch.device("cuda")
    assert _bench_util.peak_flops(torch.bfloat16, cuda)[0] == 989e12
    for matmul, conv, peak in ((False, False, 67e12), (False, True, 494.7e12),
                               (True, False, 494.7e12)):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", matmul)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", conv)
        assert _bench_util.peak_flops(torch.float32, cuda)[0] == peak
    assert _bench_util.peak_flops(torch.float32, torch.device(CPU)) == (
        None, "no peak (cpu)")


def test_p49_projection():
    got = profile_infer.p49_projection(0.1, 0.2, 4)
    assert got["chunks"] == 13
    assert got["seconds"] == pytest.approx(0.1 + 13 * 0.2)
    assert got["img_per_s"] == pytest.approx(1 / 2.7)
    assert profile_infer.p49_projection(0.1, 0.2, 49)["chunks"] == 1
    assert profile_infer.p49_projection(0.1, 0.2, 16)["chunks"] == 4


# -- the timed stage functions against the JAX package ----------------------

@pytest.fixture(scope="module")
def nets():
    cfg, jnet, _, var = tiny_jax(0)
    net, _ = port_net(cfg, var)
    return jnet, var, net


def _close(got, want, tol=1e-5):
    assert rel_err(nhwc(got), want) <= tol


def test_profile_infer_stages_match_jax(nets):
    """coarse_stage = coarse_forward + attend_coarse, chunk_stage =
    infer_tiles on broadcast ROI features, fine_stage = fine_forward (the
    JAX methods jitted)."""
    jnet, var, net = nets
    rng = np.random.default_rng(4)
    lr = rng.random((1, *TINY_SHAPE, 3), dtype=np.float32)
    crops = rng.random((2, *TINY_SHAPE, 3), dtype=np.float32)

    def jax_coarse(v, x):
        cd, cf = jnet.apply(v, x, method=JaxNet.coarse_forward)
        return cd, cf, jnet.apply(v, cf, method=JaxNet.attend_coarse)

    def bcast(f):
        return jnp.broadcast_to(f, (2,) + f.shape[1:])

    def jax_tiles(v, c, cd, cf, g2l):
        return jnet.apply(v, c, [bcast(f) for f in cf],
                          [bcast(f) for f in g2l], bcast(cd),
                          method=JaxNet.infer_tiles)

    def jax_stages(v, x, c):
        cd, cf, g2l = jax_coarse(v, x)
        return (cd, cf, g2l, jax_tiles(v, c, cd, cf, g2l),
                jnet.apply(v, c, method=JaxNet.fine_forward))

    jcd, jcf, jg2l, want, (jfd, jff) = jax.jit(jax_stages)(var, lr, crops)
    with torch.no_grad():
        coarse = profile_infer.coarse_stage(net, nchw(lr))
        rois = profile_infer.broadcast_rois(coarse, 2)
        got = profile_infer.chunk_stage(net, nchw(crops), *rois)
        fd, ff = profile_infer.fine_stage(net, nchw(crops))
    cd, cf, g2l = coarse
    for a, b in zip([cd, *cf, *g2l, got, fd, *ff],
                    [jcd, *jcf, *jg2l, want, jfd, *jff]):
        _close(a, b)


def test_profile_stitch_chain_matches_jax():
    """The engine's stitch of the m2 plan, which profile_stitch times,
    against the JAX tool's chain over the JAX package's paste_grid, AvgMap
    and blend_mask."""
    kw = dict(image_raw_shape=(84, 112), patch_split_num=(2, 2),
              patch_process_shape=TINY_SHAPE)
    tc, jtc = TileConfig(**kw), JaxTileConfig(**kw)
    passes = regular_passes(tc, "m2")
    tiles = np.random.default_rng(6).standard_normal(
        (sum(len(p.origins) for p in passes), *TINY_SHAPE)).astype(
            np.float32)
    blur = jnp.asarray(jmasks.blend_mask(jtc.patch_process_shape))
    avg, start = None, 0
    for p in passes:
        poh, pow_ = jtc.process_origins(p.offset_process)
        t = tiles[start:start + len(p.origins)]
        start += len(p.origins)
        num = jstitch.paste_grid(t * blur, poh, pow_,
                                 jtc.patch_reensemble_shape)
        den = jstitch.paste_grid(jnp.broadcast_to(blur, t.shape), poh, pow_,
                                 jtc.patch_reensemble_shape)
        avg = jstitch.AvgMap.init(num, den) if avg is None \
            else avg.update(num, den)
    got = stitch_passes(
        passes, torch.from_numpy(tiles),
        torch.from_numpy(jmasks.blend_mask(tc.patch_process_shape)),
        tc.patch_reensemble_shape).average
    assert got.shape == (84, 112)
    assert rel_err(got.numpy(), avg.average) <= 1e-5
