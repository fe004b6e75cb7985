"""PatchFusion network (patchfusion_tpu/models/patchfusion.py; reference
estimator/models/patchfusion.py and baseline_pretrain.py's tile geometry).

Frozen coarse and fine ZoeDepth branches (DA or BEiT), six fusion convs, the
guided-fusion U-Net with G2L attention and a metric-bins decoder head. As in
the JAX package, G2L attention over the whole-image coarse features runs
once per image (`attend_coarse`) and `coarse_postprocess` ROI-aligns every
level from the single whole-image copy. The tiled-inference engine lives in
engine/inference.py; the fusion stage's training forward is
`train_forward`, and `train_mode` sets the modes it needs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from patchfusion_tpu_torch.models.fusion import GuidedFusion, remat_call
from patchfusion_tpu_torch.models.zoedepth import (N_MIDAS_OUT,
                                                   MetricBinsHead,
                                                   branch_channels,
                                                   head_kwargs,
                                                   make_zoe_branch)
from patchfusion_tpu_torch.ops.roi_align import (roi_align_batched,
                                                 roi_align_single)
from patchfusion_tpu_torch.utils import profiling

# the frozen ZoeDepth branches of the fusion stage (reference
# patchfusion.py:112-115); everything else of the net is trained
FROZEN_KEYS = ("coarse_branch", "fine_branch")

# the six multi-scale features, low -> high resolution (reference
# patchfusion.py:198-204)
FEATURE_KEYS = ("x_d0", "x_blocks_feat_0", "x_blocks_feat_1",
                "x_blocks_feat_2", "x_blocks_feat_3", "midas_final_feat")


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Static tile geometry (reference baseline_pretrain.py:91-119)."""
    image_raw_shape: Tuple[int, int]
    patch_split_num: Tuple[int, int]
    patch_process_shape: Tuple[int, int]

    def __post_init__(self):
        h, w = self.image_raw_shape
        sh, sw = self.patch_split_num
        if h % (2 * sh) or w % (2 * sw):
            raise ValueError("image height and width must be divisible by "
                             "2 * patch_split_num")

    @property
    def patch_raw_shape(self) -> Tuple[int, int]:
        return (self.image_raw_shape[0] // self.patch_split_num[0],
                self.image_raw_shape[1] // self.patch_split_num[1])

    @property
    def patch_reensemble_shape(self) -> Tuple[int, int]:
        return (self.patch_process_shape[0] * self.patch_split_num[0],
                self.patch_process_shape[1] * self.patch_split_num[1])

    def regular_origins(self, offset: Tuple[int, int]
                        ) -> Tuple[List[int], List[int]]:
        """Raw-coordinate tile origins of a (possibly shifted) pass
        (reference baseline_pretrain.py:239-242)."""
        ph, pw = self.patch_raw_shape
        nh = (self.image_raw_shape[0] - offset[0]) // ph
        nw = (self.image_raw_shape[1] - offset[1]) // pw
        return ([ph * i + offset[0] for i in range(nh)],
                [pw * j + offset[1] for j in range(nw)])

    def process_origins(self, offset_process: Tuple[int, int]
                        ) -> Tuple[List[int], List[int]]:
        """Reensemble-space paste origins (baseline_pretrain.py:248-251)."""
        ph, pw = self.patch_process_shape
        nh = (self.patch_reensemble_shape[0] - offset_process[0]) // ph
        nw = (self.patch_reensemble_shape[1] - offset_process[1]) // pw
        return ([ph * i + offset_process[0] for i in range(nh)],
                [pw * j + offset_process[1] for j in range(nw)])

    def bboxes_for(self, origins_h: Sequence[int], origins_w: Sequence[int]
                   ) -> np.ndarray:
        """Raw-coordinate [x1, y1, x2, y2] boxes, float32, row-major over
        (h, w)."""
        return self.boxes_at([[y, x] for y in origins_h for x in origins_w])

    def boxes_at(self, origins) -> np.ndarray:
        """Raw-coordinate [x1, y1, x2, y2] boxes, float32, of the tiles at
        origins (N, 2) [y, x]."""
        ph, pw = self.patch_raw_shape
        o = np.asarray(origins, np.float32).reshape(-1, 2)
        return np.stack([o[:, 1], o[:, 0], o[:, 1] + pw, o[:, 0] + ph], 1)

    def bbox_to_process(self, boxes: torch.Tensor) -> torch.Tensor:
        """Raw -> process ("feature") coordinates (reference
        patchfusion.py:373-378)."""
        return boxes * box_scale(self.patch_process_shape,
                                 self.image_raw_shape, boxes.dtype,
                                 boxes.device)


def box_scale(process_shape: Tuple[int, int], raw_shape: Tuple[int, int],
              dtype: torch.dtype = torch.float32, device=None):
    """[fx, fy, fx, fy]: raw-coordinate [x1, y1, x2, y2] boxes times it are
    in process ("feature") coordinates."""
    fx = process_shape[1] / raw_shape[1]
    fy = process_shape[0] / raw_shape[0]
    return torch.tensor([fx, fy, fx, fy], dtype=dtype, device=device)


class TilePass(NamedTuple):
    offset_raw: Tuple[int, int]
    offset_process: Tuple[int, int]
    origins: np.ndarray  # (n, 2) raw [y, x], row-major
    process_origins: Tuple[List[int], List[int]]  # on the reensemble canvas


def regular_passes(tc: TileConfig, mode: str) -> Tuple[TilePass, ...]:
    """The regular passes of a parsed mode, in order, each with its raw and
    process offsets, its tiles' raw origins and their paste origins: "m1"
    the grid; "m2" and "r" (rN's regular part) the grid and its three
    half-tile shifts (reference patchfusion.py:401-453)."""
    (prh, prw), (pph, ppw) = tc.patch_raw_shape, tc.patch_process_shape
    offsets = [((0, 0), (0, 0)), ((0, prw // 2), (0, ppw // 2)),
               ((prh // 2, 0), (pph // 2, 0)),
               ((prh // 2, prw // 2), (pph // 2, ppw // 2))]
    passes = []
    for off_raw, off_proc in offsets[:1 if mode == "m1" else 4]:
        oh, ow = tc.regular_origins(off_raw)
        origins = np.array([[y, x] for y in oh for x in ow], np.int64)
        passes.append(TilePass(off_raw, off_proc, origins,
                               tc.process_origins(off_proc)))
    return tuple(passes)


class PatchFusionNet(MetricBinsHead):
    """The PatchFusion network (reference patchfusion.py:56-174); the PF
    metric-bins head's submodules sit at the top level, as in the
    reference checkpoints. remat: recompute the trainable fusion stage in
    the backward (the U-Net's blocks, G2L and the PF head, as the JAX
    package's nn.remat does); inference and the parameters are the same."""

    def __init__(self, coarse: Dict[str, Any], fine: Dict[str, Any],
                 guided_fusion: Dict[str, Any], min_depth: float = 1e-3,
                 max_depth: float = 80.0,
                 patch_process_shape: Tuple[int, int] = (392, 518),
                 remat: bool = False):
        gf = GuidedFusion(**guided_fusion, remat=remat)
        inv = list(guided_fusion.get("in_channels",
                                     (32, 256, 256, 256, 256, 256)))[::-1]
        super().__init__(inv[0], inv[1:5],
                         **head_kwargs(coarse, min_depth, max_depth))
        self.patch_process_shape = tuple(patch_process_shape)
        self.remat = remat
        self.coarse_branch = make_zoe_branch(coarse, min_depth, max_depth,
                                             self.patch_process_shape)
        self.fine_branch = make_zoe_branch(fine, min_depth, max_depth,
                                           self.patch_process_shape)
        c = branch_channels(fine)
        chans = [c] * 5 + [N_MIDAS_OUT]
        self.fusion_conv_list = nn.ModuleList(
            [nn.Conv2d(2 * ch, ch, 3, padding=1) for ch in chans])
        self.guided_fusion = gf

    @property
    def dtype(self) -> torch.dtype:
        return self.fusion_conv_list[0].weight.dtype

    @property
    def device(self) -> torch.device:
        return self.fusion_conv_list[0].weight.device

    # -- branch passes ------------------------------------------------------

    def coarse_forward(self, image_lr: torch.Tensor
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(B, 3, H, W) -> (coarse depth (B, 1, H, W), 6 features low ->
        high) (reference patchfusion.py:189-206)."""
        out = self.coarse_branch(image_lr)
        return out["metric_depth"], [out["temp_features"][k]
                                     for k in FEATURE_KEYS]

    def fine_forward(self, crops: torch.Tensor
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(N, 3, h, w) -> (fine depth (N, 1, h, w), 6 features)
        (patchfusion.py:208-225)."""
        out = self.fine_branch(crops)
        return out["metric_depth"], [out["temp_features"][k]
                                     for k in FEATURE_KEYS]

    def attend_coarse(self, coarse_feats: List[torch.Tensor]
                      ) -> List[torch.Tensor]:
        """G2L attention over whole-image coarse features, once per image."""
        return self.guided_fusion.attend_coarse(coarse_feats)

    # -- roi cropping --------------------------------------------------------

    def _roi(self, feat: torch.Tensor, boxes: torch.Tensor,
             batched: bool = False) -> torch.Tensor:
        """ROI-align (1, C, h, w) to (N, C, h, w), or with batched=True box
        i from map i of (N, C, h, w) (the training path). REFERENCE QUIRK:
        one spatial_scale, from the height, for both axes
        (patchfusion.py:232-251)."""
        h, w = feat.shape[-2:]
        scale = h / self.patch_process_shape[0]
        fn = roi_align_batched if batched else roi_align_single
        out = fn(feat.permute(0, 2, 3, 1), boxes, h, w, scale,
                 sampling_ratio=1)
        return out.permute(0, 3, 1, 2)

    def coarse_postprocess(self, coarse_depth: torch.Tensor,
                           coarse_feats: List[torch.Tensor],
                           g2l_feats: List[torch.Tensor],
                           boxes_process: torch.Tensor, batched: bool = False
                           ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                      List[torch.Tensor]]:
        """ROI-align the coarse depth and the raw and attended features to
        the tile boxes, reading the single whole-image copy, or with
        batched=True each sample's own image (patchfusion.py:227-257)."""
        return (self._roi(coarse_depth, boxes_process, batched),
                [self._roi(f, boxes_process, batched) for f in coarse_feats],
                [self._roi(f, boxes_process, batched) for f in g2l_feats])

    # -- fusion --------------------------------------------------------------

    def fusion_forward(self, fine_depth: torch.Tensor, crops: torch.Tensor,
                       coarse_feat_rois: List[torch.Tensor],
                       fine_feats: List[torch.Tensor],
                       g2l_rois: List[torch.Tensor],
                       coarse_depth_roi: torch.Tensor) -> torch.Tensor:
        """Per-tile fusion -> metric depth (N, 1, h, w)
        (reference patchfusion.py:259-340)."""
        guide_cat = [conv(torch.cat([cr, ff], dim=1))
                     for conv, cr, ff in zip(self.fusion_conv_list,
                                             coarse_feat_rois, fine_feats)]
        dt = self.dtype
        input_tensor = torch.cat([coarse_depth_roi.to(dt),
                                  fine_depth.to(dt), crops.to(dt)], dim=1)
        outputs = self.guided_fusion(input_tensor, guide_cat, g2l_rois)
        last = outputs[-1]
        # the reference's rel_cond is vestigially zero (patchfusion.py:300)
        rel_cond = torch.zeros_like(last[:, :1])
        return remat_call(self.remat, self.head_forward, outputs[0],
                          outputs[1:5], last, rel_cond)["metric_depth"]

    def infer_tiles(self, crops: torch.Tensor,
                    coarse_feat_rois: List[torch.Tensor],
                    g2l_rois: List[torch.Tensor],
                    coarse_depth_roi: torch.Tensor) -> torch.Tensor:
        """Fine pass + fusion for a batch of tiles (patchfusion.py:343-356)."""
        with profiling.span("fine"):
            fine_depth, fine_feats = self.fine_forward(crops)
        with profiling.span("fusion"):
            return self.fusion_forward(fine_depth, crops, coarse_feat_rois,
                                       fine_feats, g2l_rois,
                                       coarse_depth_roi)

    # -- training ------------------------------------------------------------

    def train_mode(self) -> "PatchFusionNet":
        """The fusion stage's modes (reference patchfusion.py:112-115): the
        two branches frozen, in eval mode and without gradients; the fusion
        convs, the guided-fusion U-Net (with G2L) and the PF head trained,
        in train mode (their BatchNorms on batch statistics)."""
        self.train()
        for name in FROZEN_KEYS:
            getattr(self, name).eval().requires_grad_(False)
        return self

    def train_forward(self, image_lr: torch.Tensor,
                      crops_image_hr: torch.Tensor, bboxs: torch.Tensor,
                      tile_cfg: Optional[TileConfig] = None) -> torch.Tensor:
        """Training forward (reference patchfusion.py:372-393): one random
        crop per sample. image_lr (B, 3, h, w) and crops_image_hr
        (B, 3, h, w) NCHW; bboxs (B, 4) raw-coordinate [x1, y1, x2, y2],
        scaled to process coordinates by tile_cfg's raw shape or the
        reference's 3840x2160. The branches run without grad; G2L, the ROI
        crops and the fusion stage carry it. Returns the per-crop depth
        (B, 1, h, w). The modes are the caller's (train_mode)."""
        raw = (2160, 3840) if tile_cfg is None else tile_cfg.image_raw_shape
        boxes_p = bboxs * box_scale(self.patch_process_shape, raw,
                                    bboxs.dtype, bboxs.device)
        with torch.no_grad():
            coarse_depth, coarse_feats = self.coarse_forward(image_lr)
            fine_depth, fine_feats = self.fine_forward(crops_image_hr)
        g2l_feats = self.attend_coarse(coarse_feats)
        depth_roi, feat_rois, g2l_rois = self.coarse_postprocess(
            coarse_depth, coarse_feats, g2l_feats, boxes_p, batched=True)
        return self.fusion_forward(fine_depth, crops_image_hr, feat_rois,
                                   fine_feats, g2l_rois, depth_roi)
