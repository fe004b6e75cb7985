"""ViT self-attention kernel: the CUDA counterpart of
patchfusion_tpu/ops/pallas_attention.py::vit_attention,
::vit_attention_blocked and ::vit_attention_mxsum.

The three TPU kernels compute one function and differ only in TPU tricks,
so the three wrappers here launch one hand-written kernel
(`csrc/vit_attention.cu`) and differ only in where they round, by two
flags:

  | wrapper                               | round_logits | round_diff |
  |---------------------------------------|--------------|------------|
  | `vit_attention`                       | on           | on         |
  | `vit_attention_blocked`               | off          | off        |
  | `vit_attention_mxsum(bf16_exp=False)` | off          | off        |
  | `vit_attention_mxsum(bf16_exp=True)`  | off          | on         |

round_logits rounds the f32 logits off the accumulator to bf16
(_attn_kernel's bf16 N^2 stage and the JAX einsum path); round_diff rounds
s - m to bf16 before exp (_attn_kernel, and _attn_kernel_mxsum's
bf16_exp, which keeps the logits in f32).

Each wrapper keeps the JAX signature: q, k and v are (B, N, H, Dh)
bfloat16, and the result is (B, N, H, Dh) bfloat16. For CPU tensors it
returns the plain twin `vit_attention_plain`; for CUDA tensors it launches
the kernel on the current stream, or raises. It never falls back from CUDA
to the twin. `LAUNCHES["vit_attention"]` counts the kernel's launches.

The kernel has no backward, and neither has the TPU kernel (no custom VJP
in pallas_attention.py). So a call that would have to carry a gradient
(grad mode on and an input that requires grad) raises, on either device,
naming PF_ATTN_IMPL: training a DINOv2 branch runs on the default einsum
path. The frozen branches of fusion training run without grad and launch
the kernel as inference does.
"""

from __future__ import annotations

import functools

import torch

from patchfusion_tpu_torch.ops.cuda_lib import (load_kernels, on_cpu,
                                                raise_on, stream)

# kernel launches since the count was last set to 0
LAUNCHES = {"vit_attention": 0}

MAX_HEAD_DIM = 128  # the widest head csrc/vit_attention.cu is compiled for


@functools.lru_cache(maxsize=None)
def bf16_scale(dh: int) -> float:
    """Dh^-0.5 rounded to bf16: JAX multiplies a bf16 array by a Python
    float in bf16 (weak typing), so the scale itself is rounded first."""
    return float(torch.tensor(float(dh) ** -0.5, dtype=torch.bfloat16))


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 batches, accumulated and returned in f32 (products of
    bf16 values are exact in f32): a tensor-core GEMM with f32 output on
    the card, an f32 GEMM on the CPU."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def vit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        round_logits: bool = True,
                        round_diff: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the JAX package's bf16 einsum
    attention (patchfusion_tpu/models/dinov2.py:85-98), rounding where it
    rounds, with the kernel's two rounding flags.

    The defaults are that function: the logits come out of an
    f32-accumulating bf16 matmul rounded to bf16, and (s - m) is taken in
    bf16 before the f32 exp. round_logits=False keeps the logits in f32;
    round_diff=False keeps s - m in f32 (_attn_kernel_blocked with both
    off, _attn_kernel_mxsum(bf16_exp=True) with only round_diff). Always the
    probabilities are rounded to bf16, the normaliser is their f32 sum, and
    the f32 P.V product is divided by it before the one rounding to bf16.
    """
    b, n, h, dh = q.shape

    def heads(x):  # (B, N, H, Dh) -> (B * H, N, Dh)
        return x.transpose(1, 2).reshape(b * h, n, dh)

    qs, kt = heads(q * bf16_scale(dh)), heads(k).transpose(1, 2)
    s = torch.bmm(qs, kt) if round_logits else _bmm_f32(qs, kt)
    d = s - s.amax(dim=-1, keepdim=True)
    d = d.to(torch.bfloat16) if round_diff else d.float()
    p = torch.exp(d).to(torch.bfloat16)
    norm = p.sum(dim=-1, keepdim=True, dtype=torch.float32)
    o = (_bmm_f32(p, heads(v)) / norm).to(q.dtype)
    return o.reshape(b, h, n, dh).transpose(1, 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raises on what the kernel does not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share a (B, N, H, Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"the attention kernel takes bfloat16 only, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    dh = q.shape[-1]
    if dh % 16 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"head width {dh} is not a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # the TMA tensor maps take byte strides that are multiples of 16
        # and a 16-byte aligned start, over a contiguous Dh
        if (t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f"{name} must have a contiguous last dimension, strides that "
                f"are multiples of 8 and a 16-byte aligned start; got "
                f"strides {t.stride()}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            round_logits: bool, round_diff: bool) -> torch.Tensor:
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "the attention kernel (PF_ATTN_IMPL=pallas) has no backward: "
            "a gradient through it was asked for. Train with PF_ATTN_IMPL "
            "unset or 'einsum', or run the attention under torch.no_grad()")
    if on_cpu(q, k, v):
        return vit_attention_plain(q, k, v, round_logits, round_diff)
    _check(q, k, v)
    b, n, h, dh = q.shape
    out = torch.empty((b, n, h, dh), dtype=torch.bfloat16, device=q.device)
    err = load_kernels().pf_vit_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, h,
        dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        bf16_scale(dh), int(round_logits), int(round_diff), q.device.index,
        stream(q.device))
    raise_on(err, "vit_attention")
    LAUNCHES["vit_attention"] += 1
    return out


def vit_attention(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """(B, N, H, Dh) bf16 self-attention, no mask, with _attn_kernel's
    rounding (bf16 logits, bf16 s - m before exp): the einsum path's
    function. Strided views such as qkv[:, :, i] go in without a copy."""
    return _launch(q, k, v, round_logits=True, round_diff=True)


def vit_attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          block_rows: int = 384) -> torch.Tensor:
    """vit_attention with f32 logits and exp (_attn_kernel_blocked).

    block_rows is the TPU kernel's query-row block, a VMEM tile size with no
    counterpart on the card (the kernel picks its own query tile). The JAX
    function halves it until it divides N rounded up to 128, which any
    positive value does; it is checked for that and otherwise not used.
    """
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    return _launch(q, k, v, round_logits=False, round_diff=False)


def vit_attention_mxsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bf16_exp: bool = False) -> torch.Tensor:
    """vit_attention with the normaliser summed from the bf16 probabilities
    (the TPU kernel rides it on the P.V matmul; this kernel always does).
    The logits stay in f32; bf16_exp=True rounds s - m to bf16 before exp,
    as _attn_kernel_mxsum does."""
    return _launch(q, k, v, round_logits=False, round_diff=bool(bf16_exp))
