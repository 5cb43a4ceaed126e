"""Muscle activation signal generator (counterpart of
``sph_tpu/models/muscle.py``).

Two traveling sine waves over 12 body rows, phase-shifted by pi, normalized
to [0, 1], each value duplicated (left/right muscle of a row) and
concatenated as [w1, w2, w2, w1] -> 96 values in quadrant order MDR, MVR,
MVL, MDL. The model is closed-form, so the step computes it on the device
from its step counter: the counter stays a tensor and no value crosses to
the host.

Timing matches the reference simulator loop: step k runs with the signal
emitted after step k-1 (waves(t = k - 1)); step 0 runs with all-zero
activation.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import ACTIVE_MUSCLE_COUNT, MUSCLE_COUNT

_N_ROWS = 12            # 24 muscles per wave, two per body row
_SPAN = 1.5 * 2 * math.pi
_WAVE_VELOCITY = 1e-4
_INCREMENT = 1.0
_ROW = np.linspace(0.0, _SPAN, _N_ROWS, dtype=np.float32)
# device -> _ROW on it. Copied once per device: the copy from host memory
# cannot run inside a CUDA graph's capture, where a step may compute the
# signal (the graphed period's warm-up makes the first copy)
_ROW_ON: dict[torch.device, torch.Tensor] = {}


def _row(device: torch.device) -> torch.Tensor:
    row = _ROW_ON.get(device)
    if row is None:
        row = _ROW_ON[device] = torch.as_tensor(_ROW, device=device)
    return row


def waves_signal(t: torch.Tensor) -> torch.Tensor:
    """Activation vector [..., MUSCLE_COUNT] for wave time ``t`` (an f32
    tensor, scalar or batched), on ``t``'s device."""
    t = t.to(torch.float32)
    row = _row(t.device)
    phase = (float(np.float32(_WAVE_VELOCITY)) * t
             * float(np.float32(_INCREMENT)))[..., None]
    w1 = (torch.sin(row - phase) + 1.0) * 0.5
    w2 = (torch.sin(row + float(np.float32(math.pi)) - phase) + 1.0) * 0.5
    d1 = torch.repeat_interleave(w1, 2, dim=-1)  # left/right muscle of a row
    d2 = torch.repeat_interleave(w2, 2, dim=-1)
    pad = d1.new_zeros(d1.shape[:-1] + (MUSCLE_COUNT - ACTIVE_MUSCLE_COUNT,))
    return torch.cat([d1, d2, d2, d1, pad], dim=-1)  # MDR, MVR, MVL, MDL


def next_activation(step: torch.Tensor) -> torch.Tensor:
    """Signal to apply during step ``step + 1`` (emitted at end of ``step``)."""
    return waves_signal(step.to(torch.float32))


def schedule(n_steps: int, device="cuda") -> torch.Tensor:
    """Precomputed [n_steps, MUSCLE_COUNT] activation table on ``device``
    (the card unless the caller names the CPU): row k is the activation
    used by step k (row 0 is all zeros)."""
    t = torch.arange(-1, n_steps - 1, dtype=torch.float32, device=device)
    table = waves_signal(t)
    table[0] = 0.0
    return table
