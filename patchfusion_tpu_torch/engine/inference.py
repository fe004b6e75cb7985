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

With a `mesh` (parallel/dist.PatchMesh, the JAX package's `patch` mesh over
ranks, one device each) every rank runs the coarse pass and G2L, takes one
contiguous share of each tile stream (padded to a multiple of the ranks by
repeating the last tile; the duplicates are dropped) and pastes its tiles
alone; the ranks then sum their canvases, and the average updates as in
one process, since it composes additively (ops/stitch.py). rN draws its
random tiles in groups of the mesh's size, as the JAX mesh engine does.
Unlike the JAX mesh engine, a rank keeps `process_num` chunking inside its
share: on one card the chunk bounds memory, where on a TPU the shard is
the chunk.

Images come in the JAX package's layout (NHWC, float in [0, 1]); tensors
inside are NCHW on the model's device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from patchfusion_tpu_torch.models.patchfusion import (
    PatchFusionNet, TileConfig, TilePass, box_scale, regular_passes)
from patchfusion_tpu_torch.ops.masks import blend_mask
from patchfusion_tpu_torch.ops.resize import interpolate, interpolate_nchw
from patchfusion_tpu_torch.ops.stitch import AvgMap, paste_dynamic, paste_grid
from patchfusion_tpu_torch.parallel.dist import (PatchMesh, all_reduce_,
                                                 broadcast_object)
from patchfusion_tpu_torch.utils import profiling


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


class TilePlan(NamedTuple):
    """A mode's tile plan on an engine's device (`PatchFusionInference.
    _plan`): `boxes` are the process-space boxes of the regular tiles this
    engine runs (under a mesh its share, `_share`)."""
    passes: Tuple[TilePass, ...]
    origins: np.ndarray  # every regular tile's raw origin, pass after pass
    blur: torch.Tensor
    scale: torch.Tensor  # raw -> process box coordinates
    boxes: torch.Tensor
    blur_raw: Optional[torch.Tensor]  # rN's raw-resolution blend mask


def paste_pass(tile_pass: TilePass, tiles: torch.Tensor, blur: torch.Tensor,
               canvas_hw: Tuple[int, int], owned=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One regular pass's canvases (num, den): its tiles (n, ph, pw) times
    the blend mask, and the mask (times `owned` (n,) under a mesh)."""
    poh, pow_ = tile_pass.process_origins
    weight = blur if owned is None else blur * owned[:, None, None]
    return (paste_grid(tiles * blur, poh, pow_, canvas_hw),
            paste_grid(weight.expand(tiles.shape), poh, pow_, canvas_hw))


def stitch_passes(passes: Tuple[TilePass, ...], tiles: torch.Tensor,
                  blur: torch.Tensor, canvas_hw: Tuple[int, int],
                  owned: Optional[torch.Tensor] = None,
                  reduce: Optional[Callable] = None) -> AvgMap:
    """The regular passes' stitch of their tiles (n_all, ph, pw): each
    pass's canvases (`paste_pass`), under a mesh summed across the ranks
    by `reduce`, folded into one running AvgMap."""
    counts = [len(p.origins) for p in passes]
    shares = [None] * len(passes) if owned is None else owned.split(counts)
    canvases = [paste_pass(p, t, blur, canvas_hw, o) for p, t, o in zip(
        passes, tiles.split(counts), shares)]
    if owned is not None:
        canvases = reduce(canvases)
    avg = None
    for num, den in canvases:
        avg = AvgMap.init(num, den) if avg is None else avg.update(num, den)
    return avg


class PatchFusionInference:
    """Tiled inference for a PatchFusionNet (modes m1, m2, rN; reference
    docs/user_infer.md:4-37)."""

    def __init__(self, net: PatchFusionNet, tile_cfg: TileConfig,
                 process_num: Optional[int] = 4,
                 rn_times_process_num: bool = False, fusion: bool = True,
                 mesh: Optional[PatchMesh] = None):
        """fusion=False: fine-branch depth per tile, no coarse pass; `net`
        then needs only `fine_forward`, `dtype` and `device`. mesh: split
        every pass's tiles across mesh.size ranks (module docstring)."""
        self.net = net
        self.tile_cfg = tile_cfg
        self.process_num = process_num
        self.rn_times_process_num = rn_times_process_num
        self.fusion = fusion
        self.mesh = mesh
        # rN tiles are drawn in groups of this size: process_num in one
        # process, the mesh's size under a mesh (the JAX tile_group)
        self.tile_group = mesh.size if mesh is not None else process_num
        self._plans: Dict[str, TilePlan] = {}

    @property
    def device(self) -> torch.device:
        return self.net.device

    # -- internals -----------------------------------------------------------

    def _plan(self, mode: str) -> TilePlan:
        """The tile plan of a parsed mode ("m1", "m2", "r"), built on its
        first use and kept for the engine's life."""
        if mode not in self._plans:
            tc, dev = self.tile_cfg, self.device
            passes = regular_passes(tc, mode)
            origins = np.concatenate([p.origins for p in passes])
            mine = origins if self.mesh is None \
                else origins[self._share(len(origins))[2]]
            scale = box_scale(tc.patch_process_shape, tc.image_raw_shape,
                              device=dev)
            self._plans[mode] = TilePlan(
                passes, origins,
                torch.from_numpy(blend_mask(tc.patch_process_shape)).to(dev),
                scale, torch.from_numpy(tc.boxes_at(mine)).to(dev) * scale,
                torch.from_numpy(blend_mask(tc.patch_raw_shape)).to(dev)
                if mode == "r" else None)
        return self._plans[mode]

    def _tile_batch(self, image_hr: torch.Tensor, origins: np.ndarray,
                    boxes: Optional[torch.Tensor], coarse_ctx
                    ) -> torch.Tensor:
        """Fine + fusion for tiles at `origins` with process-space `boxes`
        on the device -> depth (N, ph, pw) f32, `process_num` tiles at a
        time with chunk-local ROIs."""
        tc = self.tile_cfg
        with profiling.span("crop"):
            crops = crop_resize_tiles(image_hr, origins, tc.patch_raw_shape,
                                      tc.patch_process_shape, self.net.dtype)
        n = crops.shape[0]
        profiling.count("tiles", n)
        chunk = self.process_num or n
        outs = []
        for s in range(0, n, chunk):
            with profiling.span("chunk"):
                profiling.count("chunks")
                if not self.fusion:
                    with profiling.span("fine"):
                        depth, _ = self.net.fine_forward(crops[s:s + chunk])
                else:
                    with profiling.span("roi"):
                        droi, frois, grois = self.net.coarse_postprocess(
                            *coarse_ctx, boxes[s:s + chunk])
                    # pf.fine and pf.fusion open inside infer_tiles
                    depth = self.net.infer_tiles(crops[s:s + chunk], frois,
                                                 grois, droi)
                outs.append(depth[:, 0].float())
        return torch.cat(outs)

    def _coarse_ctx(self, image_lr: torch.Tensor):
        if not self.fusion:
            # a fine-only engine never reads the coarse pass
            return None
        with profiling.span("coarse"):
            with profiling.span("coarse_branch"):
                coarse_depth, coarse_feats = self.net.coarse_forward(
                    image_lr)
            with profiling.span("g2l"):
                g2l_feats = self.net.attend_coarse(coarse_feats)
        return coarse_depth, coarse_feats, g2l_feats

    def _image_stream(self, image_hr: torch.Tensor, rand_origins: np.ndarray,
                      coarse_ctx, mode: str) -> torch.Tensor:
        """Tiled inference for ONE image (3, H, W) given its coarse
        context."""
        tc = self.tile_cfg
        dev = self.device
        # pf.stitch: the plan's build on a mode's first request, the
        # canvases and the average after the tiles, rN's raw-res pastes
        with profiling.span("stitch"):
            plan = self._plan(mode)

        # all regular passes' tiles as one stream
        tiles_all, owned = self._shared_tiles(image_hr, plan, coarse_ctx)

        with profiling.span("stitch"):
            avg = stitch_passes(plan.passes, tiles_all, plan.blur,
                                tc.patch_reensemble_shape, owned,
                                self._sum_canvases)

        if mode == "r" and len(rand_origins):
            with profiling.span("stitch"):
                avg = avg.resize(tc.image_raw_shape)
                num = torch.zeros(tc.image_raw_shape, device=dev)
                den = torch.zeros(tc.image_raw_shape, device=dev)
            if self.mesh is not None:
                first, mine, _ = self._share(len(rand_origins))
                rand_origins = rand_origins[first:first + mine]
            group = self.process_num or 1
            for s in range(0, len(rand_origins), group):
                g = rand_origins[s:s + group]
                # random tiles differ every request: their boxes go up here
                boxes = torch.from_numpy(tc.boxes_at(g)).to(dev) \
                    * plan.scale if self.fusion else None
                tiles = self._tile_batch(image_hr, g, boxes, coarse_ctx)
                with profiling.span("stitch"):
                    # the reference resizes tile depth to the raw tile size
                    # with F.interpolate's default mode, nearest (bp:203)
                    tiles = interpolate(tiles[..., None], tc.patch_raw_shape,
                                        mode="nearest")[..., 0]
                    num += paste_dynamic(tiles * plan.blur_raw, g,
                                         tc.image_raw_shape)
                    den += paste_dynamic(plan.blur_raw.expand(tiles.shape),
                                         g, tc.image_raw_shape)
            with profiling.span("stitch"):
                if self.mesh is not None:
                    (num, den), = self._sum_canvases([(num, den)])
                avg = avg.update(num, den)
        return avg.average

    def _random_tiles(self, cai_mode: str, rng, rand_origins, n_images: int):
        group = self.tile_group or 1
        mode, n_random = _parse_mode(cai_mode, group,
                                     self.rn_times_process_num)
        if mode != "r":
            return mode, [np.zeros((0, 2), np.int64)] * n_images
        if rand_origins is not None:
            rand = np.asarray(rand_origins, np.int64)
            rand = list(rand.reshape(n_images, -1, 2))
        else:
            rng = rng or np.random.default_rng(0)
            rand = [self.random_origins(n_random, rng).astype(np.int64)
                    for _ in range(n_images)]
        if self.mesh is not None:
            # every rank pastes the same tiles: rank 0's origins
            rand = broadcast_object(rand)
        return mode, rand

    # -- the tile split (mesh) -----------------------------------------------

    def _share(self, n: int) -> Tuple[int, int, np.ndarray]:
        """This rank's contiguous share of a stream of n tiles padded to a
        multiple of the mesh's size by repeating the last tile: (its first
        index, how many of its tiles are not padding, its indices into the
        stream)."""
        per = -(-n // self.mesh.size)
        first = self.mesh.rank * per
        idx = np.minimum(np.arange(first, first + per), n - 1)
        return first, int(np.clip(n - first, 0, per)), idx

    def _shared_tiles(self, image_hr: torch.Tensor, plan: TilePlan,
                      coarse_ctx):
        """(depth (N, ph, pw), owned): every tile's depth in one process
        (owned None); under a mesh, this rank's tiles at their places in
        the stream and zeros elsewhere, and owned (N,) 1 at this rank's
        tiles and 0 elsewhere."""
        if self.mesh is None:
            return self._tile_batch(image_hr, plan.origins, plan.boxes,
                                    coarse_ctx), None
        n = len(plan.origins)
        first, mine, idx = self._share(n)
        local = self._tile_batch(image_hr, plan.origins[idx], plan.boxes,
                                 coarse_ctx)
        ph, pw = self.tile_cfg.patch_process_shape
        tiles = local.new_zeros((n, ph, pw))
        tiles[first:first + mine] = local[:mine]
        owned = local.new_zeros(n)
        owned[first:first + mine] = 1.0
        return tiles, owned

    def _sum_canvases(self, canvases):
        """Each pass's (num, den) summed across the mesh, in one
        all-reduce."""
        stacked = torch.stack([c for pair in canvases for c in pair])
        all_reduce_(stacked)
        return [(stacked[2 * i], stacked[2 * i + 1])
                for i in range(len(canvases))]

    def _to_device(self, image: np.ndarray) -> torch.Tensor:
        """NHWC numpy (or tensor) -> NCHW float32 tensor on the device."""
        t = torch.as_tensor(np.asarray(image, np.float32))
        with profiling.span("h2d"):
            profiling.count("h2d_bytes", t.nbytes)
            t = t.to(self.device)
        return t.movedim(-1, -3)

    # -- public API ----------------------------------------------------------

    def shard_report(self, cai_mode: str = "m1") -> Dict[str, Any]:
        """Per-pass shard accounting for a mode under the current mesh, with
        the JAX package's keys and arithmetic (engine/inference.py
        shard_report): tiles per pass, the padding the split adds, the
        tiles each rank runs, and the coarse pass that every rank
        repeats."""
        ndev = self.mesh.size if self.mesh is not None else 1
        group = self.tile_group or 1
        mode, n_rand = _parse_mode(cai_mode, group, self.rn_times_process_num)
        counts = [len(p.origins) for p in regular_passes(self.tile_cfg, mode)]
        total = sum(counts)
        padded = total + (-total) % ndev
        rand_padded = (n_rand // group) * (group + (-group) % ndev)

        work = padded + rand_padded
        useful = total + n_rand
        return {
            "devices": ndev,
            "pass_tiles": counts,
            "regular_tiles": total,
            "regular_padded": padded,
            "random_tiles": n_rand,
            "random_padded": rand_padded,
            "tiles_per_device": work // max(ndev, 1),
            "padding_waste_frac": round(1.0 - useful / work, 4) if work
            else 0.0,
            "coarse_pass_replicas": ndev,
        }

    def random_origins(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """Random tile origins with the reference's distribution
        (baseline_pretrain.py:155-156: per group of tile_group tiles, an
        independent h per tile but ONE shared w). Copied from the JAX
        package so the same rng gives the same draws."""
        tc = self.tile_cfg
        pn = self.tile_group or 1
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
