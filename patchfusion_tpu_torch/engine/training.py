"""Training step and optimizer (patchfusion_tpu/engine/training.py;
reference estimator/trainer/trainer.py wiring: AdamW, grad-norm clip 0.1,
a per-iteration OneCycle schedule, configs/** optim_wrapper and
param_scheduler).

The PatchFusion stage trains only the fusion part (the six fusion convs,
the guided-fusion U-Net with G2L and the PF metric-bins head); both
ZoeDepth branches are frozen (reference patchfusion.py:112-115). As in the
JAX package this is structural: the optimizer holds only the trainable
parameters, the branches carry no gradient and, under --amp, are stored in
bf16.

The schedule is the JAX package's (optax's), not torch's OneCycleLR, whose
phase boundaries lie elsewhere: `OneCycleAdamW` computes the learning rate
and Adam's b1 of each step by the JAX formulas and writes them into the
optimizer's param group before the step, reading the step counter where
optax's inject_hyperparams reads it (before the update). The clip is
optax's clip_by_global_norm (no epsilon), not clip_grad_norm_'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from patchfusion_tpu_torch.models.fusion import FlaxBatchNorm2d
from patchfusion_tpu_torch.models.losses import SILogLoss
from patchfusion_tpu_torch.models.patchfusion import FROZEN_KEYS

Params = Dict[str, torch.Tensor]

# the loader's image (HWC) and depth (HW1) keys, which become NCHW
_MAP_KEYS = ("image_lr", "crops_image_hr", "image_hr", "depth_gt",
             "crop_depths")


def split_params(net: nn.Module) -> Tuple[Params, Params]:
    """-> (trainable, frozen) parameters of a PatchFusionNet by their
    state_dict names: the frozen part is the two branches."""
    trainable, frozen = {}, {}
    for name, p in net.named_parameters():
        (frozen if name.split(".")[0] in FROZEN_KEYS else trainable)[name] = p
    return trainable, frozen


def batch_stats(net: nn.Module) -> Params:
    """The BatchNorm running statistics of `net` (the JAX package's
    `batch_stats` collection), by state_dict name."""
    out = {}
    for mname, m in net.named_modules():
        if isinstance(m, FlaxBatchNorm2d):
            for b in ("running_mean", "running_var", "num_batches_tracked"):
                out[f"{mname}.{b}"] = getattr(m, b)
    return out


class OneCycleAdamW:
    """AdamW + OneCycle (cosine) learning rate + cycled b1 + global-norm
    clipping: the JAX package's make_onecycle_optimizer (the reference's
    mmengine optim_wrapper + OneCycleLR, configs/.../
    depthanything_vitl_patchfusion_u4k.py:96-108), as a torch AdamW whose
    lr and b1 are set before each step. `init(params)` makes the optimizer
    (optax's tx.init); `update(optimizer, params, step)` clips, sets the
    step's hyperparameters and steps."""

    def __init__(self, max_lr: float, total_steps: int,
                 pct_start: float = 0.25, div_factor: float = 10.0,
                 final_div_factor: float = 10000.0,
                 base_momentum: float = 0.85, max_momentum: float = 0.95,
                 weight_decay: float = 0.001, clip_norm: float = 0.1):
        self.max_lr = max_lr
        self.total_steps = total_steps
        if total_steps > 1:
            # optax's onecycle yields nan when a phase rounds to zero
            # steps: both phases last at least one step
            pct_start = min(max(pct_start, 1.0 / total_steps),
                            1.0 - 1.0 / total_steps)
        self.pct_start = pct_start
        self.div_factor = div_factor
        self.final_div_factor = final_div_factor
        self.base_momentum = base_momentum
        self.max_momentum = max_momentum
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def lr(self, step: int) -> float:
        """optax.cosine_onecycle_schedule (piecewise cosine between the
        accumulated values at the boundaries), or max_lr / div_factor for a
        one-step run (optax.constant_schedule)."""
        init = self.max_lr / self.div_factor
        if self.total_steps <= 1:
            return init
        bounds = [0, int(self.pct_start * self.total_steps),
                  int(self.total_steps)]
        values = [init, init * self.div_factor,
                  init / self.final_div_factor]
        if step >= bounds[-1]:
            return values[-1]
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                     + 1)
        return 0.0  # a negative step

    def b1(self, step: int) -> float:
        """torch's cycle_momentum, as the JAX package writes it: b1
        anneals max -> base while the lr rises, base -> max while it
        falls (cosine)."""
        warm = self.total_steps * self.pct_start
        up = min(max(step / max(warm, 1), 0.0), 1.0)
        down = min(max((step - warm) / max(self.total_steps - warm, 1),
                       0.0), 1.0)
        span = self.max_momentum - self.base_momentum
        if step <= warm:
            return self.base_momentum + span * 0.5 * (1 + math.cos(
                math.pi * up))
        return self.base_momentum + span * 0.5 * (1 - math.cos(
            math.pi * down))

    def init(self, params: List[torch.Tensor]) -> torch.optim.AdamW:
        """optax.adamw's defaults: b2 0.999, eps 1e-8; weight decay on every
        parameter; lr and b1 are set per step."""
        return torch.optim.AdamW(params, lr=self.lr(0),
                                 betas=(self.b1(0), 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)

    def update(self, optimizer: torch.optim.Optimizer,
               params: List[torch.Tensor], step: int) -> torch.Tensor:
        """Clip the gradients of `params` to a global norm of clip_norm
        (optax.clip_by_global_norm: scaled by clip_norm / norm only where
        norm >= clip_norm), set step's lr and b1, step. Returns the global
        norm before the clip (a 0-d tensor on the gradients' device)."""
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.nn.utils.get_total_norm(grads)
        scale = torch.where(norm < self.clip_norm, 1.0,
                            self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)
        for group in optimizer.param_groups:
            group["lr"] = self.lr(step)
            group["betas"] = (self.b1(step), group["betas"][1])
        optimizer.step()
        return norm


def make_onecycle_optimizer(max_lr: float, total_steps: int,
                            pct_start: float = 0.25,
                            div_factor: float = 10.0,
                            final_div_factor: float = 10000.0,
                            base_momentum: float = 0.85,
                            max_momentum: float = 0.95,
                            weight_decay: float = 0.001,
                            clip_norm: float = 0.1) -> OneCycleAdamW:
    """The JAX package's make_onecycle_optimizer, with its defaults."""
    return OneCycleAdamW(max_lr, total_steps, pct_start, div_factor,
                         final_div_factor, base_momentum, max_momentum,
                         weight_decay, clip_norm)


@dataclasses.dataclass
class TrainState:
    """The JAX package's TrainState over a torch module: `step` counts the
    optimizer steps taken; the trainable and frozen parameters and the BN
    statistics live in `net` (views below); `optimizer` holds the AdamW
    state of the trainable ones. `amp`: compute under bf16 autocast."""
    step: int
    net: nn.Module
    tx: OneCycleAdamW
    optimizer: torch.optim.Optimizer
    params: List[torch.Tensor]
    amp: bool = False

    @property
    def trainable(self) -> Params:
        return split_params(self.net)[0]

    @property
    def frozen(self) -> Params:
        return split_params(self.net)[1]

    @property
    def batch_stats(self) -> Params:
        return batch_stats(self.net)


def create_train_state(net: nn.Module, tx: OneCycleAdamW,
                       frozen_dtype: Optional[torch.dtype] = None,
                       amp: bool = False) -> TrainState:
    """A PatchFusionNet ready for the fusion stage: the trainable part
    float32 in train mode, the branches in eval mode without gradients
    (stored in `frozen_dtype` where given: bf16 under --amp, halving their
    memory), and the optimizer over the trainable parameters."""
    net.float()
    if frozen_dtype is not None:
        for name in FROZEN_KEYS:
            getattr(net, name).to(frozen_dtype)
    net.train_mode()
    params = list(split_params(net)[0].values())
    return TrainState(step=0, net=net, tx=tx, optimizer=tx.init(params),
                      params=params, amp=amp)


def create_branch_state(branch: nn.Module, tx: OneCycleAdamW
                        ) -> TrainState:
    """A ZoeDepth branch ready for pretraining: every parameter trained,
    float32, train mode."""
    branch.float().train().requires_grad_(True)
    params = list(branch.parameters())
    return TrainState(step=0, net=branch, tx=tx, optimizer=tx.init(params),
                      params=params)


def to_device_batch(batch: Dict[str, Any], device, keys) -> Dict[str,
                                                                 torch.Tensor]:
    """A loader batch (numpy, NHWC images and HW1 depths) -> float32 NCHW
    tensors on `device`, for the keys the step reads."""
    out = {}
    for k in keys:
        if k not in batch:
            continue
        t = torch.as_tensor(batch[k]).to(device=device, dtype=torch.float32,
                                         non_blocking=True)
        out[k] = t.movedim(-1, 1) if k in _MAP_KEYS else t
    return out


def _autocast(state: TrainState, device: torch.device):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=state.amp)


def fusion_loss(state: TrainState, batch: Dict[str, torch.Tensor],
                loss_fn: SILogLoss, min_depth: float, max_depth: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and backward of one fusion step: (loss, pred), with the
    trainable parameters' gradients set (none accumulated from before).
    Under amp the forward runs in bf16 autocast over the f32 masters; the
    loss is reduced in f32."""
    net = state.net
    for p in state.params:
        p.grad = None
    with _autocast(state, batch["image_lr"].device):
        pred = net.train_forward(batch["image_lr"], batch["crops_image_hr"],
                                 batch["bboxs"])
    loss = loss_fn(pred, batch["crop_depths"], min_depth, max_depth)
    loss.backward()
    _zero_missing_grads(state.params)
    return loss.detach(), pred.detach()


def _zero_missing_grads(params: List[torch.Tensor]) -> None:
    """A zero gradient for each parameter the loss does not reach (the
    sixth fusion conv, whose output no decoder level reads; G2L's dead
    area-prior projection): optax's AdamW decays every leaf, torch's skips
    a parameter without a gradient."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def make_train_step(loss_fn: Optional[SILogLoss] = None,
                    min_depth: float = 1e-3, max_depth: float = 80.0
                    ) -> Callable:
    """One fusion-stage training step (reference trainer.py:219-272 inner
    loop + patchfusion.py:372-397 train forward): step(state, batch) takes
    the batch as NCHW tensors on the net's device (to_device_batch),
    updates the state in place and returns the logs: total_loss, sig_loss,
    grad_norm (before the clip) and pred[:1] (the first crop's depth, for
    the trainer's image panels). The boxes scale by the 3840x2160 default
    raw size, as the JAX step's train_forward call does."""
    sig = loss_fn or SILogLoss()

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        loss, pred = fusion_loss(state, batch, sig, min_depth, max_depth)
        norm = state.tx.update(state.optimizer, state.params, state.step)
        state.step += 1
        return {"total_loss": loss, "sig_loss": loss, "grad_norm": norm,
                "pred": pred[:1]}

    return step


def branch_loss(state: TrainState, batch: Dict[str, torch.Tensor],
                target: str, loss_fn: SILogLoss, min_depth: float,
                max_depth: float) -> torch.Tensor:
    """Forward and backward of one branch step: the coarse target on
    image_lr against depth_gt, the fine one on crops_image_hr against
    crop_depths (reference baseline_pretrain.py:347-360)."""
    x = batch["image_lr" if target == "coarse" else "crops_image_hr"]
    y = batch["depth_gt" if target == "coarse" else "crop_depths"]
    for p in state.params:
        p.grad = None
    with _autocast(state, x.device):
        pred = state.net(x)["metric_depth"]
    loss = loss_fn(pred, y, min_depth, max_depth)
    loss.backward()
    _zero_missing_grads(state.params)
    return loss.detach()


def make_branch_train_step(target: str = "coarse", min_depth: float = 1e-3,
                           max_depth: float = 80.0) -> Callable:
    """Stage-1/2 pretraining step (reference baseline_pretrain.py:347-360):
    step(state, batch) trains one ZoeDepth branch on whole images (coarse)
    or random crops (fine) and returns {"total_loss"}."""
    if target not in ("coarse", "fine"):
        raise ValueError(f"target must be 'coarse' or 'fine', not "
                         f"{target!r}")
    sig = SILogLoss()

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        loss = branch_loss(state, batch, target, sig, min_depth, max_depth)
        state.tx.update(state.optimizer, state.params, state.step)
        state.step += 1
        return {"total_loss": loss}

    return step
