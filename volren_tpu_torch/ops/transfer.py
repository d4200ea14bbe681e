"""Transfer-function LUT lookup (reference shader/common.glsl:195-212), in
torch: the counterpart of volren_tpu.ops.transfer with exact f32 gathers
(its ``onehot=False`` path). The render kernel repeats these expressions
operation for operation."""

from __future__ import annotations

import torch

from .scene import TFTables

# upper clamp of the windowed coordinate, so the bin index stays < size
WINDOW_MAX = 1.0 - 1e-6


def tf_window(tf: TFTables, d: torch.Tensor) -> torch.Tensor:
    return torch.clamp((d - tf.window_left) / tf.window_width, 0.0, WINDOW_MAX)


def _lerp_index(tf: TFTables, d: torch.Tensor):
    size = tf.lut.shape[0]
    tc = tf_window(tf, d) * float(size)
    idx = torch.floor(tc).to(torch.int32)
    fr = tc - idx.to(torch.float32)
    return idx.long(), torch.clamp(idx + 1, max=size - 1).long(), fr


def tf_lookup(tf: TFTables, d: torch.Tensor) -> torch.Tensor:
    """Windowed, linearly interpolated LUT fetch: (N,) -> (N, 4)."""
    idx, idx1, fr = _lerp_index(tf, d)
    fr = fr[..., None]
    return tf.lut[idx] * (1.0 - fr) + tf.lut[idx1] * fr


def tf_alpha_majorant(tf: TFTables, d: torch.Tensor) -> torch.Tensor:
    """The lerped LUT alpha alone, the majorant's classification fetch
    (common.glsl:484)."""
    idx, idx1, fr = _lerp_index(tf, d)
    alpha = tf.lut[:, 3]
    return alpha[idx] * (1.0 - fr) + alpha[idx1] * fr
