"""How a model config's branch family maps onto the weight converters
(patchfusion_tpu/convert/__init__.py): the DA (DINOv2) family needs the
ViT depth; the midas (BEiT) family also needs the relative-position grid
of the process shape."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from patchfusion_tpu_torch.models.beit import BEIT_CONFIGS, PATCH
from patchfusion_tpu_torch.models.dinov2 import VIT_CONFIGS


def branch_conversion_spec(model_config: Dict[str, Any]
                           ) -> Tuple[str, int, Optional[Tuple[int, int]]]:
    """model.config dict -> (family, backbone depth, BEiT grid or None).

    family: 'da' (type='DA-ZoeDepth', DINOv2 core) or 'midas'
    (type='ZoeDepth', BEiT core; reference zoedepth_v1.py:300-305). The
    BEiT grid is patch_process_shape // 16."""
    branch = model_config["coarse_branch"]
    if branch.get("type", "DA-ZoeDepth") == "ZoeDepth":
        mt = branch.get("midas_model_type", "DPT_BEiT_L_384")
        pph, ppw = model_config["patch_process_shape"]
        return "midas", BEIT_CONFIGS[mt]["depth"], (pph // PATCH,
                                                    ppw // PATCH)
    mt = branch.get("midas_model_type", "vitl")
    return "da", VIT_CONFIGS[mt]["depth"], None
