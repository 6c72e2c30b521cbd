"""Depth loss and eval metrics (port of `ssl4gie_tpu/metrics/depth.py`).

The scale-and-shift-invariant loss: a per-image closed-form least-squares
scale and shift aligns the prediction to the target on its valid pixels
(target > 0), then a masked MSE over the batch, plus (alpha > 0) a 4-scale
gradient-matching term. Gradients flow through the alignment, as in the JAX
package (no stop-gradient). Eval: align, clamp to [0, 1], zero the invalid
pixels, x10 metric scale, then per-image RMSE, median relative error and
mean absolute error. All in float32.
"""

from __future__ import annotations

import torch

from ssl4gie_tpu_torch.parallel.distributed import batch_divisor

F32 = torch.float32


def _sum_hw(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=(1, 2))


def compute_scale_and_shift(prediction, target, mask):
    """Closed-form 2x2 least squares per image over (B, H, W) inputs: the
    (scale, shift) pair, each (B,), zero where the system is singular."""
    prediction, target, mask = (t.to(F32) for t in (prediction, target,
                                                     mask))
    a00 = _sum_hw(mask * prediction * prediction)
    a01 = _sum_hw(mask * prediction)
    a11 = _sum_hw(mask)
    b0 = _sum_hw(mask * prediction * target)
    b1 = _sum_hw(mask * target)
    det = a00 * a11 - a01 * a01
    valid = det != 0
    safe_det = torch.where(valid, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    x0 = torch.where(valid, (a11 * b0 - a01 * b1) / safe_det, zero)
    x1 = torch.where(valid, (-a01 * b0 + a00 * b1) / safe_det, zero)
    return x0, x1


def _ratio(num_per_image, divisor):
    """sum(num) / divisor over the batch, 0 where the divisor is 0; the
    divisor is the global batch's when the batch is split over ranks
    (`distributed.batch_divisor`)."""
    divisor = batch_divisor(divisor)
    return torch.where(divisor == 0, torch.zeros_like(divisor),
                       torch.sum(num_per_image)
                       / torch.clamp(divisor, min=1e-38))


def _masked_mse(prediction, target, mask):
    res = prediction - target
    return _ratio(_sum_hw(mask * res * res), torch.sum(2.0 * _sum_hw(mask)))


def _gradient_loss_single(prediction, target, mask):
    diff = mask * (prediction - target)
    grad_x = torch.abs(diff[:, :, 1:] - diff[:, :, :-1]) * \
        (mask[:, :, 1:] * mask[:, :, :-1])
    grad_y = torch.abs(diff[:, 1:, :] - diff[:, :-1, :]) * \
        (mask[:, 1:, :] * mask[:, :-1, :])
    return _ratio(_sum_hw(grad_x) + _sum_hw(grad_y),
                  torch.sum(_sum_hw(mask)))


def gradient_loss(prediction, target, mask, scales: int = 4):
    """The gradient-matching term summed over `scales` strides 1, 2, 4,
    8."""
    total = 0.0
    for s in range(scales):
        step = 2 ** s
        total = total + _gradient_loss_single(prediction[:, ::step, ::step],
                                              target[:, ::step, ::step],
                                              mask[:, ::step, ::step])
    return total


def _squeeze_f32(x: torch.Tensor) -> torch.Tensor:
    return (x[..., 0] if x.ndim == 4 else x).to(F32)


def _aligned(prediction, target):
    """(the aligned prediction, the valid mask) for (B, H, W) f32 inputs."""
    mask = (target > 0).to(F32)
    scale, shift = compute_scale_and_shift(prediction, target, mask)
    return scale[:, None, None] * prediction + shift[:, None, None], mask


def ssi_eval_pair(prediction, target):
    """Per-image (numerator, denominator) of the alpha = 0 SSI eval loss:
    sum(num[valid]) / sum(den[valid]) over a padded eval batch gives the
    loss of the unpadded batch. Inputs (B, H, W) or (B, H, W, 1)."""
    prediction, target = _squeeze_f32(prediction), _squeeze_f32(target)
    pred_ssi, mask = _aligned(prediction, target)
    res = pred_ssi - target
    return _sum_hw(mask * res * res), 2.0 * _sum_hw(mask)


def ssi_loss(prediction, target, alpha: float = 0.1, scales: int = 4):
    """prediction, target: (B, H, W) or (B, H, W, 1); mask = target > 0.
    alpha 0.1 trains, alpha 0 is the val / selection loss."""
    prediction, target = _squeeze_f32(prediction), _squeeze_f32(target)
    pred_ssi, mask = _aligned(prediction, target)
    total = _masked_mse(pred_ssi, target, mask)
    if alpha > 0:
        total = total + alpha * gradient_loss(pred_ssi, target, mask, scales)
    return total


def aligned_prediction(prediction, target):
    """The prediction scale- and shift-aligned to the target ((B, H, W))."""
    return _aligned(prediction, target)[0]


def depth_eval_metrics(pred_aligned, target, metric_scale: float = 10.0):
    """Per-image RMSE, median relative error and mean absolute error over
    the valid pixels ((B, H, W) inputs): the prediction clamped to [0, 1]
    and zeroed where the target is 0, both x `metric_scale`. The median of
    an even count is the mean of the two middle values, as `jnp.nanmedian`
    takes it (`torch.nanmedian` would take the lower one)."""
    pred = torch.clamp(pred_aligned, 0.0, 1.0)
    mask = target > 0
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    pred = torch.where(mask, pred, zero) * metric_scale
    gt = target * metric_scale
    n = torch.clamp(_sum_hw(mask), min=1)
    err = pred - gt
    rmse = torch.sqrt(_sum_hw(torch.where(mask, err * err, zero)) / n)
    abs_err = _sum_hw(torch.where(mask, torch.abs(err), zero)) / n
    rel = torch.where(mask, torch.abs(err) / torch.clamp(gt, min=1e-12),
                      torch.full_like(err, float("nan")))
    med_rel = torch.nanquantile(rel.reshape(rel.shape[0], -1), 0.5, dim=1)
    return {"rmse": rmse, "med_rel_err": med_rel, "abs_err": abs_err}
