"""ZoeDepth inference-time augmentation (patchfusion_tpu/engine/tta.py;
reference external/zoedepth/models/depth_model.py:47-152): reflect-pad the
input (pad = sqrt(dim/2)*3), resize to the minimal multiple, run, resize
back bicubic and crop; optionally average with the horizontally flipped
pass. Images are NHWC tensors, as in the JAX package; `infer_pil` takes a
PIL image."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from patchfusion_tpu_torch.ops.resize import (interpolate,
                                              minimal_multiple_resize_size)


def zoe_infer(apply_fn, x: torch.Tensor, pad_input: bool = True,
              with_flip_aug: bool = True, fh: float = 3.0, fw: float = 3.0,
              multiple_of: int = 14) -> torch.Tensor:
    """apply_fn: (B, H, W, 3) -> dict with 'metric_depth' (B, H, W, 1).
    x: (B, H, W, 3). Returns (B, H, W, 1).

    The reference pads arbitrarily and relies on the core's internal Resize
    (PrepForMidas, do_resize=True) to reach a multiple-of-14 size; the
    branch has no internal resize, so the padded input is resized here with
    the same 'minimal multiple-of' rule before the forward pass."""

    def infer_pad(xx):
        h, w = xx.shape[1:3]
        if pad_input:
            pad_h = int(np.sqrt(h / 2) * fh)
            pad_w = int(np.sqrt(w / 2) * fw)
            xx = F.pad(xx.movedim(-1, 1), (pad_w, pad_w, pad_h, pad_h),
                       mode="reflect").movedim(1, -1)
        ph, pw = xx.shape[1:3]
        nh, nw = minimal_multiple_resize_size(ph, pw, ph, pw, multiple_of)
        net_in = xx if (nh, nw) == (ph, pw) else interpolate(
            xx, (nh, nw), mode="bilinear", align_corners=True)
        out = apply_fn(net_in)["metric_depth"]
        if tuple(out.shape[1:3]) != (ph, pw):
            out = interpolate(out, (ph, pw), mode="bicubic",
                              align_corners=False)
        if pad_input:
            if pad_h > 0:
                out = out[:, pad_h:-pad_h]
            if pad_w > 0:
                out = out[:, :, pad_w:-pad_w]
        return out

    out = infer_pad(x)
    if with_flip_aug:
        out_flip = infer_pad(x.flip(2))
        out = (out + out_flip.flip(2)) / 2.0
    return out



def infer_pil(apply_fn, pil_img, pad_input: bool = True,
              with_flip_aug: bool = True, output_type: str = "numpy",
              device="cuda"):
    """PIL image convenience wrapper (depth_model.py:135-152): the image as
    a (1, H, W, 3) float tensor in [0, 1] on `device` (the card unless the
    caller asks for the CPU), through zoe_infer without gradients.
    output_type "numpy": the (H, W) depth as a float32 array; "pil": a
    uint16 image of depth * 256; "tensor": the (H, W) depth on `device`."""
    if output_type not in ("numpy", "pil", "tensor"):
        raise ValueError(f"output_type {output_type} not supported")
    from patchfusion_tpu_torch.models.builder import check_device

    x = torch.from_numpy(np.asarray(pil_img, np.float32)[None] / 255.0)
    with torch.no_grad():
        out = zoe_infer(apply_fn, x.to(check_device(device)), pad_input,
                        with_flip_aug).squeeze()
    if output_type == "tensor":
        return out
    out = out.float().cpu().numpy()
    if output_type == "pil":
        from PIL import Image
        return Image.fromarray((out * 256).astype(np.uint16))
    return out
