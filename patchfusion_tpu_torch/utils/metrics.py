"""Depth evaluation metrics (patchfusion_tpu/utils/metrics.py; reference
estimator/utils/metric.py).

a1/a2/a3, abs_rel, sq_rel, rmse, rmse_log, log_10, silog + SEE (soft edge
error on GT boundary pixels), with the reference's masking/crop semantics
(compute_metrics, mt:87-148). Pure numpy (scipy and cv2 imported where
used); the pred-to-GT resize is bilinear align_corners=False (mt:94) with
the port's copy of the JAX package's weight matrices.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from patchfusion_tpu_torch.ops.resize import resize_matrix


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    """Standard 9 metrics over pre-masked flat arrays (mt:10-50)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25 ** 2).mean())
    a3 = float((thresh < 1.25 ** 3).mean())
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))
    rmse = float(np.sqrt(((gt - pred) ** 2).mean()))
    rmse_log = float(np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean()))
    err = np.log(pred) - np.log(gt)
    silog = float(np.sqrt(np.mean(err ** 2) - np.mean(err) ** 2) * 100)
    log_10 = float(np.abs(np.log10(gt) - np.log10(pred)).mean())
    return dict(a1=a1, a2=a2, a3=a3, abs_rel=abs_rel, rmse=rmse,
                log_10=log_10, rmse_log=rmse_log, silog=silog, sq_rel=sq_rel)


def _shift2d(data: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """Shift with zero fill (mt:54-66)."""
    out = np.roll(data, dx, axis=1)
    if dx < 0:
        out[:, dx:] = 0
    elif dx > 0:
        out[:, :dx] = 0
    out = np.roll(out, dy, axis=0)
    if dy < 0:
        out[dy:, :] = 0
    elif dy > 0:
        out[:dy, :] = 0
    return out


def soft_edge_error(pred: np.ndarray, gt: np.ndarray,
                    radius: int = 1) -> np.ndarray:
    """min over a (2r+1)^2 neighborhood of |gt_shifted - pred| (mt:67-72)."""
    diffs = [np.abs(_shift2d(gt, i, j) - pred)
             for i in range(-radius, radius + 1)
             for j in range(-radius, radius + 1)]
    return np.minimum.reduce(diffs)


def get_boundaries(disp: np.ndarray, th: float = 1.0,
                   dilation: int = 10) -> np.ndarray:
    """GT disparity edges by forward/backward gradient threshold
    (mt:74-85)."""
    ey = np.logical_or(
        np.pad(np.abs(disp[1:, :] - disp[:-1, :]) > th, ((1, 0), (0, 0))),
        np.pad(np.abs(disp[:-1, :] - disp[1:, :]) > th, ((0, 1), (0, 0))))
    ex = np.logical_or(
        np.pad(np.abs(disp[:, 1:] - disp[:, :-1]) > th, ((0, 0), (1, 0))),
        np.pad(np.abs(disp[:, :-1] - disp[:, 1:]) > th, ((0, 0), (0, 1))))
    edges = np.logical_or(ey, ex).astype(np.float32)
    if dilation > 0:
        try:
            import cv2
            kernel = np.ones((dilation, dilation), np.uint8)
            edges = cv2.dilate(edges, kernel, iterations=1)
        except ImportError:
            from scipy import ndimage
            edges = ndimage.grey_dilation(
                edges, size=(dilation, dilation)).astype(np.float32)
    return edges


def resize_pred_to_gt(pred: np.ndarray, gt_shape) -> np.ndarray:
    """Bilinear align_corners=False (mt:91-94)."""
    if pred.shape == tuple(gt_shape):
        return pred
    wh = resize_matrix(gt_shape[0], pred.shape[0], "bilinear", False)
    ww = resize_matrix(gt_shape[1], pred.shape[1], "bilinear", False)
    return wh @ pred.astype(np.float32) @ ww.T


def compute_metrics(gt: np.ndarray, pred: np.ndarray,
                    interpolate: bool = True, garg_crop: bool = False,
                    eigen_crop: bool = True, dataset: str = "nyu",
                    min_depth_eval: float = 0.1,
                    max_depth_eval: float = 10.0,
                    disp_gt_edges: Optional[np.ndarray] = None,
                    additional_mask: Optional[np.ndarray] = None
                    ) -> Dict[str, float]:
    """Full eval protocol (mt:87-148): resize pred to GT, clamp, valid mask
    by depth range, optional garg/eigen crop, 9 metrics + SEE over GT
    boundary pixels."""
    gt_depth = np.asarray(gt).squeeze()
    pred = np.asarray(pred).squeeze()
    if pred.shape != gt_depth.shape and interpolate:
        pred = resize_pred_to_gt(pred, gt_depth.shape)

    pred = pred.copy()
    pred[pred < min_depth_eval] = min_depth_eval
    pred[pred > max_depth_eval] = max_depth_eval
    pred[np.isinf(pred)] = max_depth_eval
    pred[np.isnan(pred)] = min_depth_eval

    valid_mask = np.logical_and(gt_depth > min_depth_eval,
                                gt_depth < max_depth_eval)
    if garg_crop or eigen_crop:
        gh, gw = gt_depth.shape
        eval_mask = np.zeros_like(valid_mask)
        if garg_crop:
            eval_mask[int(0.40810811 * gh):int(0.99189189 * gh),
                      int(0.03594771 * gw):int(0.96405229 * gw)] = 1
        elif eigen_crop:
            if dataset == "kitti":
                eval_mask[int(0.3324324 * gh):int(0.91351351 * gh),
                          int(0.0359477 * gw):int(0.96405229 * gw)] = 1
            else:
                eval_mask[45:471, 41:601] = 1
        valid_mask = np.logical_and(valid_mask, eval_mask)
    if additional_mask is not None:
        valid_mask = np.logical_and(valid_mask,
                                    np.asarray(additional_mask).squeeze())

    metrics = compute_errors(gt_depth[valid_mask], pred[valid_mask])

    if disp_gt_edges is not None:
        edges = np.asarray(disp_gt_edges).squeeze()
        mask = np.logical_and(valid_mask, edges.astype(bool))
        see = 0.0
        if mask.sum() > 0:
            see = float(soft_edge_error(pred, gt_depth)[mask].mean())
        metrics["see"] = see
    return metrics



# non-maximum suppression: each quantized gradient direction (degrees mod
# 180) and the two neighbours (dy, dx) it compares with
_NMS_NEIGHBOURS = {0: ((0, 1), (0, -1)), 45: ((-1, 1), (1, -1)),
                   90: ((-1, 0), (1, 0)), 135: ((-1, -1), (1, 1))}


def extract_edges(depth: np.ndarray, preprocess: Optional[str] = None,
                  sigma: float = 1.0, mask: Optional[np.ndarray] = None,
                  use_canny: bool = True) -> np.ndarray:
    """Depth-map edges (mt:168-206), a boolean map. The reference runs
    skimage.feature.canny; this is the JAX package's scipy Canny: Gaussian
    smoothing, Sobel, non-maximum suppression over 4 directions and
    hysteresis at 0.1 / 0.2 of the maximum (skimage's defaults), after the
    preprocess: "log" (log depth), "inv" (inverse depth scaled to [0, 1])
    or None (log base 1.5); non-positive depth maps to 0. use_canny=False
    (the reference's Sobel edges) raises NotImplementedError, as there."""
    from scipy import ndimage

    depth = np.asarray(depth, np.float64).squeeze()
    eps = np.finfo(np.float32).eps
    if preprocess == "log":
        depth = np.where(depth > 0, np.log(np.clip(depth, eps, None)), 0.0)
    elif preprocess == "inv":
        d = np.where(depth > 0, 1.0 / np.clip(depth, eps, None), 0.0)
        d -= d.min()
        d /= max(d.max(), 1e-12)
        depth = d
    else:
        depth = np.where(depth > 0,
                         np.log(np.clip(depth, eps, None)) / np.log(1.5),
                         0.0)
    if not use_canny:
        raise NotImplementedError("Sobel edge detection not implemented")

    smoothed = ndimage.gaussian_filter(depth, sigma)
    gy = ndimage.sobel(smoothed, axis=0)
    gx = ndimage.sobel(smoothed, axis=1)
    mag = np.hypot(gx, gy)
    if mag.max() > 0:
        mag = mag / mag.max()
    angle = np.rad2deg(np.arctan2(gy, gx)) % 180
    q = np.where(angle < 22.5, 0,
                 np.where(angle < 67.5, 45,
                          np.where(angle < 112.5, 90,
                                   np.where(angle < 157.5, 135, 0))))
    h, w = mag.shape
    pad = np.pad(mag, 1)
    nms = np.zeros_like(mag)
    for ang, ((dy1, dx1), (dy2, dx2)) in _NMS_NEIGHBOURS.items():
        n1 = pad[1 + dy1:1 + dy1 + h, 1 + dx1:1 + dx1 + w]
        n2 = pad[1 + dy2:1 + dy2 + h, 1 + dx2:1 + dx2 + w]
        keep = (mag >= n1) & (mag >= n2) & (q == ang)
        nms[keep] = mag[keep]
    # hysteresis: the weak components (8-connected) that hold a strong pixel
    labels, _ = ndimage.label(nms > 0.1, structure=np.ones((3, 3)))
    strong = np.unique(labels[nms > 0.2])
    edges = np.isin(labels, strong[strong > 0])
    if mask is not None:
        edges = np.logical_and(edges, mask)
    return edges
