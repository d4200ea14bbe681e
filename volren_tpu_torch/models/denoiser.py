"""Monte-Carlo denoiser: a compact UNet over (3, H, W) HDR renders, the
torch counterpart of volren_tpu.models.denoiser.

It consumes the datasets of ``scripts.datagen_denoise`` (fp16 ``color``
(N, 3, H, W) noisy / converged pairs) and trains with an SMAPE loss in log
space, which copes with the unbounded range of path-traced HDR output.

As in the flax model, the convolutions run in bf16 on f32 parameters (the
default ``dtype``); the last convolution runs in f32 on f32 input, and
``log1p`` / ``expm1`` run in f32. ``dtype=torch.float32`` runs everything in
f32. The convolutions are ``torch.nn.functional.conv2d`` (cuDNN on the
card): the JAX package computes them with XLA, not in a Pallas kernel.

Parameters cross between the packages: ``from_flax_params`` turns a flax
parameter tree (HWIO kernels) into this model's ``state_dict`` (OIHW), and
``save_params`` / ``load_params`` write and read the JAX package's pickle of
numpy arrays under flax's names, so either package loads the other's file.
The optimiser is optax's ``adamw`` under its
``cosine_decay_schedule(lr, 20_000, alpha=0.05)``, written as
``torch.optim.AdamW`` with optax's weight decay (1e-4, not torch's 1e-2) and
a ``LambdaLR`` evaluated, like optax's, at the step count before the update.
"""

from __future__ import annotations

import math
import pickle
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DECAY_STEPS = 20_000      # cosine_decay_schedule(lr, 20_000, alpha=0.05)
DECAY_ALPHA = 0.05
WEIGHT_DECAY = 1e-4       # optax.adamw's default
BETAS, EPS = (0.9, 0.999), 1e-8


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # flax's Conv(dtype=...) promotes the input, kernel and bias to dtype
    args = (x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype))
    if dtype == torch.float32 and x.is_cuda:
        # an f32 convolution in f32, not cuDNN's default TF32
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            return F.conv2d(*args, padding=1)
    return F.conv2d(*args, padding=1)


class ConvBlock(nn.Module):
    """Two 3x3 'SAME' convolutions, each followed by SiLU."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList([nn.Conv2d(in_channels, features, 3, padding=1),
                                    nn.Conv2d(features, features, 3, padding=1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = F.silu(_conv(conv, x, self.dtype))
        return x


class Denoiser(nn.Module):
    """UNet: an encoder / decoder with skip connections and a residual
    output in log space. ``blocks`` are flax's ConvBlock_0 .. ConvBlock_n
    (encoders, bottleneck, decoders, in call order), ``head`` its Conv_0."""

    def __init__(self, features: Sequence[int] = (32, 64, 96),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features, self.dtype = tuple(features), dtype
        blocks, ch = [], 3
        for f in self.features[:-1]:
            blocks.append(ConvBlock(ch, f, dtype))
            ch = f
        blocks.append(ConvBlock(ch, self.features[-1], dtype))
        ch = self.features[-1]
        for f in reversed(self.features[:-1]):
            blocks.append(ConvBlock(ch + f, f, dtype))
            ch = f
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Conv2d(ch, 3, 3, padding=1)

    def forward(self, x_nchw: torch.Tensor) -> torch.Tensor:
        logx = torch.log1p(torch.clamp(x_nchw.float(), min=0.0))
        h = logx.to(self.dtype)
        n_down = len(self.features) - 1
        skips = []
        for block in self.blocks[:n_down]:
            h = block(h)
            skips.append(h)
            h = F.avg_pool2d(h, 2, 2)
        h = self.blocks[n_down](h)
        for block, skip in zip(self.blocks[n_down + 1:], reversed(skips)):
            # jax.image.resize "nearest": half-pixel centres
            h = F.interpolate(h, size=skip.shape[-2:], mode="nearest-exact")
            h = block(torch.cat([h, skip], dim=1))
        residual = _conv(self.head, h.float(), torch.float32)
        return torch.expm1(torch.clamp(logx + residual, min=0.0))


def init_params(model: Denoiser, seed: int = 0) -> Denoiser:
    """flax's default initialisation from a torch generator seeded with
    ``seed``: LeCun-normal kernels (truncated at two deviations), zero
    biases. The draws are torch's, not JAX's: to start from a JAX model's
    parameters, load them (``from_flax_params``)."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                # variance_scaling(1, fan_in, truncated_normal): the std of
                # the normal truncated at +-2 is 0.8796 of the untruncated
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
                m.weight.copy_(w)
                m.bias.zero_()
    return model


def smape(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b) / (torch.abs(a) + torch.abs(b) + 0.01))


def cosine_decay(step: int) -> float:
    """optax.cosine_decay_schedule's factor at ``step`` (the count before
    the update)."""
    frac = min(step, DECAY_STEPS) / DECAY_STEPS
    return (1.0 - DECAY_ALPHA) * 0.5 * (1.0 + math.cos(math.pi * frac)) + DECAY_ALPHA


def create_train_state(seed: int = 0, lr: float = 1e-3, patch: int = 64,
                       features: Sequence[int] = (32, 64, 96), device="cuda",
                       dtype: torch.dtype = torch.bfloat16):
    """(model, optimizer, scheduler): a freshly initialised Denoiser on
    ``device``, optax.adamw's AdamW and its cosine decay. ``patch`` is the
    training patch size, kept for volren_tpu's signature (flax shapes its
    parameters on a sample input; these do not depend on it)."""
    del patch
    model = init_params(Denoiser(features, dtype), seed).to(device)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=BETAS, eps=EPS,
                            weight_decay=WEIGHT_DECAY)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay)
    return model, opt, sched


def train_step(model: Denoiser, opt, sched, noisy, clean) -> torch.Tensor:
    """One AdamW step on a batch of (N, 3, H, W) noisy / clean patches;
    returns the loss before the step, SMAPE in log space."""
    dev = next(model.parameters()).device
    noisy = torch.as_tensor(noisy, dtype=torch.float32, device=dev)
    clean = torch.as_tensor(clean, dtype=torch.float32, device=dev)
    pred = model(noisy)
    loss = smape(torch.log1p(torch.clamp(pred, min=0.0)),
                 torch.log1p(torch.clamp(clean, min=0.0)))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def denoise_image(model: Denoiser, hdr_hwc) -> torch.Tensor:
    """Denoise one (H, W, 3) HDR image, an array or a tensor (e.g.
    ``Renderer.fbo_data()``); returns (H, W, 3) float32 on the model's
    device."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(hdr_hwc, dtype=torch.float32, device=dev).permute(2, 0, 1)[None]
    with torch.no_grad():
        out = model(x)
    return out[0].permute(1, 2, 0)


# ---- parameters under flax's names ----

def _flax_names(model: Denoiser):
    """(flax path, torch module) of every convolution."""
    for i, block in enumerate(model.blocks):
        for j, conv in enumerate(block.convs):
            yield ("params", f"ConvBlock_{i}", f"Conv_{j}"), conv
    yield ("params", "Conv_0"), model.head


def from_flax_params(tree, model: Denoiser | None = None) -> dict:
    """A flax parameter tree of numpy arrays ({"params": {"ConvBlock_0":
    {"Conv_0": {"kernel": (3, 3, in, out), "bias": (out,)}, ...}, ...}})
    as ``model``'s state_dict (a default Denoiser's when None): HWIO
    kernels become OIHW."""
    model = Denoiser() if model is None else model
    names = {conv: name for name, conv in model.named_modules() if isinstance(conv, nn.Conv2d)}
    state = {}
    for path, conv in _flax_names(model):
        node = tree
        for key in path:
            node = node[key]
        kernel = np.asarray(node["kernel"], np.float32)
        state[f"{names[conv]}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        state[f"{names[conv]}.bias"] = torch.from_numpy(np.array(node["bias"], np.float32))
    return state


def to_flax_params(model: Denoiser) -> dict:
    """``model``'s parameters as a flax tree of numpy arrays (HWIO)."""
    tree: dict = {}
    for path, conv in _flax_names(model):
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node["kernel"] = conv.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0).copy()
        node["bias"] = conv.bias.detach().float().cpu().numpy().copy()
    return tree


def save_params(path: str, model: Denoiser) -> None:
    """Pickle ``model``'s parameters as volren_tpu's save_params does: a
    nested dict of numpy arrays under flax's names."""
    with open(path, "wb") as f:
        pickle.dump(to_flax_params(model), f)


def load_params(path: str) -> dict:
    """The parameter tree of a file written by either package's
    save_params (nested dicts of numpy arrays; no JAX needed)."""
    with open(path, "rb") as f:
        return pickle.load(f)
