"""Tiled 4K inference engine (patchfusion_tpu/engine/inference.py; reference
estimator/models/patchfusion.py:401-453 and baseline_pretrain.py:143-331).

Per image: one coarse ZoeDepth pass and one G2L pass over the coarse
features. The tiles of all regular passes form one stream that runs through
crop + resize, then, per chunk of `process_num` tiles, ROI-align of the
coarse pyramid (chunk-local, from the single whole-image copy), the fine
pass and the fusion network. Tiles are stitched with Gaussian blend masks
into a running weighted average: m1 is one pass of P*Q tiles, m2 adds three
half-tile-shifted passes, rN adds N random tiles blended at raw resolution.

With fusion=False (the BaselinePretrain fine target) the tiles run through
the fine branch alone and the coarse pass and G2L are skipped.

Images come in the JAX package's layout (NHWC, float in [0, 1]); tensors
inside are NCHW on the model's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from patchfusion_tpu_torch.models.patchfusion import PatchFusionNet, TileConfig
from patchfusion_tpu_torch.ops.masks import blend_mask
from patchfusion_tpu_torch.ops.resize import interpolate, interpolate_nchw
from patchfusion_tpu_torch.ops.stitch import AvgMap, paste_dynamic, paste_grid


def crop_resize_tiles(image_hr: torch.Tensor, origins: np.ndarray,
                      patch_raw: Tuple[int, int],
                      process_shape: Tuple[int, int],
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Crop + resize: image (3, H, W) and origins (N, 2) [y, x] -> tiles
    (N, 3, ph, pw), resized bilinear align_corners=True (the reference
    `Resize` transform). With a bf16 model the crops are cast to bf16
    before the resize, as every consumer would cast them anyway."""
    th, tw = patch_raw
    crops = torch.stack([image_hr[:, y:y + th, x:x + tw]
                         for y, x in np.asarray(origins).tolist()])
    if crops.dtype == torch.float32 and compute_dtype == torch.bfloat16:
        crops = crops.to(torch.bfloat16)
    return interpolate_nchw(crops, process_shape, mode="bilinear",
                            align_corners=True)


def _parse_mode(cai_mode: str, group: int, rn_times_process_num: bool
                ) -> Tuple[str, int]:
    """(mode, number of random tiles). Unknown modes (e.g. "p16") behave as
    m1, a reference quirk."""
    if cai_mode.startswith("r"):
        n = int(cai_mode[1:])
        # BaselinePretrain runs N random groups of process_num tiles
        # (reference bp:407-410); PatchFusion runs N // process_num groups
        # (pf:445)
        return "r", (n * group if rn_times_process_num
                     else (n // group) * group)
    if cai_mode in ("m1", "m2"):
        return cai_mode, 0
    return "m1", 0


class PatchFusionInference:
    """Tiled inference for a PatchFusionNet (modes m1, m2, rN; reference
    docs/user_infer.md:4-37)."""

    def __init__(self, net: PatchFusionNet, tile_cfg: TileConfig,
                 process_num: Optional[int] = 4,
                 rn_times_process_num: bool = False, fusion: bool = True):
        """fusion=False: fine-branch depth per tile, no coarse pass; `net`
        then needs only `fine_forward`, `dtype` and `device`."""
        self.net = net
        self.tile_cfg = tile_cfg
        self.process_num = process_num
        self.rn_times_process_num = rn_times_process_num
        self.fusion = fusion

    @property
    def device(self) -> torch.device:
        return self.net.device

    # -- internals -----------------------------------------------------------

    def _boxes_process(self, origins: np.ndarray) -> torch.Tensor:
        """Tile origins (N, 2) [y, x] -> process-space [x1, y1, x2, y2]."""
        tc = self.tile_cfg
        o = np.asarray(origins, np.float32)
        boxes = np.stack([o[:, 1], o[:, 0], o[:, 1] + tc.patch_raw_shape[1],
                          o[:, 0] + tc.patch_raw_shape[0]], axis=1)
        return tc.bbox_to_process(torch.from_numpy(boxes).to(self.device))

    def _tile_batch(self, image_hr: torch.Tensor, origins: np.ndarray,
                    coarse_ctx) -> torch.Tensor:
        """Fine + fusion for tiles at `origins` -> depth (N, ph, pw) f32,
        `process_num` tiles at a time with chunk-local ROIs."""
        tc = self.tile_cfg
        crops = crop_resize_tiles(image_hr, origins, tc.patch_raw_shape,
                                  tc.patch_process_shape, self.net.dtype)
        n = crops.shape[0]
        chunk = self.process_num or n
        outs = []
        if not self.fusion:
            for s in range(0, n, chunk):
                depth, _ = self.net.fine_forward(crops[s:s + chunk])
                outs.append(depth[:, 0].float())
            return torch.cat(outs)
        boxes = self._boxes_process(origins)
        coarse_depth, coarse_feats, g2l_feats = coarse_ctx
        for s in range(0, n, chunk):
            droi, frois, grois = self.net.coarse_postprocess(
                coarse_depth, coarse_feats, g2l_feats, boxes[s:s + chunk])
            depth = self.net.infer_tiles(crops[s:s + chunk], frois, grois,
                                         droi)
            outs.append(depth[:, 0].float())
        return torch.cat(outs)

    def _coarse_ctx(self, image_lr: torch.Tensor):
        if not self.fusion:
            # a fine-only engine never reads the coarse pass
            return None
        coarse_depth, coarse_feats = self.net.coarse_forward(image_lr)
        return coarse_depth, coarse_feats, \
            self.net.attend_coarse(coarse_feats)

    def _image_stream(self, image_hr: torch.Tensor, rand_origins: np.ndarray,
                      coarse_ctx, mode: str) -> torch.Tensor:
        """Tiled inference for ONE image (3, H, W) given its coarse
        context."""
        tc = self.tile_cfg
        dev = self.device
        offsets = [((0, 0), (0, 0))]
        if mode in ("m2", "r"):
            prh, prw = tc.patch_raw_shape
            pph, ppw = tc.patch_process_shape
            offsets += [((0, prw // 2), (0, ppw // 2)),
                        ((prh // 2, 0), (pph // 2, 0)),
                        ((prh // 2, prw // 2), (pph // 2, ppw // 2))]
        pass_grids = [tc.regular_origins(off_raw) for (off_raw, _) in offsets]
        blur = torch.from_numpy(blend_mask(tc.patch_process_shape)).to(dev)

        # all regular passes' tiles as one stream
        counts = [len(oh) * len(ow) for (oh, ow) in pass_grids]
        all_origins = np.concatenate([
            np.array([[y, x] for y in oh for x in ow], np.int64)
            for (oh, ow) in pass_grids])
        tiles_all = self._tile_batch(image_hr, all_origins, coarse_ctx)

        avg = None
        start = 0
        for (_, off_proc), n in zip(offsets, counts):
            poh, pow_ = tc.process_origins(off_proc)
            tiles = tiles_all[start:start + n]
            start += n
            num = paste_grid(tiles * blur, poh, pow_,
                             tc.patch_reensemble_shape)
            den = paste_grid(blur.expand(tiles.shape), poh, pow_,
                             tc.patch_reensemble_shape)
            avg = AvgMap.init(num, den) if avg is None \
                else avg.update(num, den)

        if mode == "r" and len(rand_origins):
            avg = avg.resize(tc.image_raw_shape)
            blur_raw = torch.from_numpy(
                blend_mask(tc.patch_raw_shape)).to(dev)
            group = self.process_num or 1
            num = torch.zeros(tc.image_raw_shape, device=dev)
            den = torch.zeros(tc.image_raw_shape, device=dev)
            for s in range(0, len(rand_origins), group):
                g = rand_origins[s:s + group]
                tiles = self._tile_batch(image_hr, g, coarse_ctx)
                # the reference resizes tile depth to the raw tile size with
                # F.interpolate's default mode, nearest (bp:203)
                tiles = interpolate(tiles[..., None], tc.patch_raw_shape,
                                    mode="nearest")[..., 0]
                num += paste_dynamic(tiles * blur_raw, g, tc.image_raw_shape)
                den += paste_dynamic(blur_raw.expand(tiles.shape), g,
                                     tc.image_raw_shape)
            avg = avg.update(num, den)
        return avg.average

    def _random_tiles(self, cai_mode: str, rng, rand_origins, n_images: int):
        group = self.process_num or 1
        mode, n_random = _parse_mode(cai_mode, group,
                                     self.rn_times_process_num)
        if mode != "r":
            return mode, [np.zeros((0, 2), np.int64)] * n_images
        if rand_origins is not None:
            rand = np.asarray(rand_origins, np.int64)
            return mode, list(rand.reshape(n_images, -1, 2))
        rng = rng or np.random.default_rng(0)
        return mode, [self.random_origins(n_random, rng).astype(np.int64)
                      for _ in range(n_images)]

    def _to_device(self, image: np.ndarray) -> torch.Tensor:
        """NHWC numpy (or tensor) -> NCHW float32 tensor on the device."""
        t = torch.as_tensor(np.asarray(image, np.float32))
        return t.to(self.device).movedim(-1, -3)

    # -- public API ----------------------------------------------------------

    def random_origins(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """Random tile origins with the reference's distribution
        (baseline_pretrain.py:155-156: per group of process_num tiles, an
        independent h per tile but ONE shared w). Copied from the JAX
        package so the same rng gives the same draws."""
        tc = self.tile_cfg
        pn = self.process_num or 1
        n_groups = n // pn
        hs, ws = [], []
        for _ in range(n_groups):
            w = rng.integers(0, tc.image_raw_shape[1]
                             - tc.patch_raw_shape[1] - 1, endpoint=True)
            for _ in range(pn):
                h = rng.integers(0, tc.image_raw_shape[0]
                                 - tc.patch_raw_shape[0] - 1, endpoint=True)
                hs.append(h)
                ws.append(w)
        return np.stack([np.array(hs), np.array(ws)], -1).astype(np.int32)

    @torch.no_grad()
    def infer(self, image_lr, image_hr, cai_mode: str = "m1",
              rng: Optional[np.random.Generator] = None,
              rand_origins: Optional[np.ndarray] = None) -> torch.Tensor:
        """image_lr: (1, h, w, 3) process-resolution whole image; image_hr:
        (H, W, 3) raw image. Returns depth (H', W') float32 on the device:
        reensemble resolution for m1/m2, raw resolution for rN."""
        mode, rand = self._random_tiles(cai_mode, rng, rand_origins, 1)
        ctx = self._coarse_ctx(self._to_device(image_lr))
        return self._image_stream(self._to_device(image_hr), rand[0], ctx,
                                  mode)

    @torch.no_grad()
    def infer_batch(self, images_lr, images_hr, cai_mode: str = "m1",
                    rng: Optional[np.random.Generator] = None,
                    rand_origins: Optional[np.ndarray] = None
                    ) -> torch.Tensor:
        """images_lr (B, h, w, 3), images_hr (B, H, W, 3) -> depth
        (B, H', W'): one coarse pass over the whole batch, then each image's
        tile stream. rand_origins (rN): (B, N, 2)."""
        b = len(images_hr)
        mode, rand = self._random_tiles(cai_mode, rng, rand_origins, b)
        ctx = self._coarse_ctx(self._to_device(images_lr))
        hr = self._to_device(images_hr)

        def image_ctx(i):
            if ctx is None:
                return None
            depth, feats, g2l = ctx
            return (depth[i:i + 1], [f[i:i + 1] for f in feats],
                    [f[i:i + 1] for f in g2l])

        return torch.stack([
            self._image_stream(hr[i], rand[i], image_ctx(i), mode)
            for i in range(b)])
