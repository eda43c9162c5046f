"""Autoregressive sliding-window rollout (plain Python loop).

Counterpart of ``motionmixerconv_tpu/train/autoregressive.py``. A model
trained on (input_n_model -> output_n_model) windows is rolled over a longer
sequence in ``step_window`` strides; per-step losses are summed and
normalised by output_n_dataset // step_window. With teacher forcing every
step reads ground truth, so all windows run as one batched forward; the
closed loop feeds each prediction back into the next window.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def rollout_starts(input_n_dataset: int, output_n_dataset: int,
                   input_n_model: int, output_n_model: int,
                   step_window: int) -> np.ndarray:
    """Window start offsets of the rollout."""
    if output_n_dataset % step_window != 0:
        raise ValueError("output_n_dataset does not divide by step_window")
    if output_n_dataset // step_window < 1:
        raise ValueError("output_n_dataset is smaller than step_window")
    hi = input_n_dataset + output_n_dataset - input_n_model - output_n_model + 1
    return np.arange(0, hi, step_window)


def autoregressive_rollout(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    full_sequence: torch.Tensor,
    *,
    input_n_model: int,
    output_n_model: int,
    step_window: int,
    teacher_forcing: bool,
    loss_per_sample: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the rollout; returns (per_sample_loss (B,), full_prediction
    (B, n_steps * output_n_model, D) stitched with later steps overwriting
    earlier ones where windows overlap)."""
    b, total_len, d = full_sequence.shape
    starts = [int(s) for s in rollout_starts(
        input_n_model, total_len - input_n_model, input_n_model,
        output_n_model, step_window)]
    n_steps = len(starts)
    n_norm = (total_len - input_n_model) // step_window
    gt_steps = [full_sequence[:, s + input_n_model: s + input_n_model
                              + output_n_model] for s in starts]

    if teacher_forcing:
        in_steps = torch.stack(
            [full_sequence[:, s: s + input_n_model] for s in starts])
        preds = apply_fn(in_steps.reshape(n_steps * b, input_n_model, d))
        preds = preds.reshape(n_steps, b, output_n_model, d)
        per_sample = sum(loss_per_sample(preds[s], gt_steps[s])
                         for s in range(n_steps)) / n_norm
        full_predict = full_sequence.new_zeros((b, total_len - input_n_model, d))
        for s in range(n_steps):
            full_predict[:, starts[s]: starts[s] + output_n_model] = preds[s]
        return per_sample, full_predict

    if output_n_model != step_window:
        raise ValueError(
            "closed-loop rollout requires output_n_model == step_window "
            "(the feedback concat keeps the window length fixed)")
    window = full_sequence[:, :input_n_model]
    losses, preds = [], []
    for s in range(n_steps):
        pred = apply_fn(window)
        losses.append(loss_per_sample(pred, gt_steps[s]))
        preds.append(pred)
        window = torch.cat([window[:, step_window:], pred], dim=1)
    return sum(losses) / n_norm, torch.cat(preds, dim=1)
