"""Neural style transfer (the port of scripts/styletransfer.py).

Adam descends directly on the pixels of an image, against a VGG11 content
loss plus a Gram-matrix SMAPE style loss, masked by content > 0 (reference
styletransfer.py:47-73,103-133).

The VGG11 features come from a cached torchvision checkpoint
``<torch hub dir>/checkpoints/vgg11-*.pth`` when one is there (read with
torch.load alone; nothing is downloaded), else from random filters drawn
with the same numpy calls as the JAX script (``default_rng(seed)``, He
normal, zero bias), so both scripts hold the same weights. The optimiser
is the JAX script's ``optax.chain(clip(c), scale_by_adam(b1, b2),
scale_by_learning_rate(exponential_decay(lr, 1, gamma)))`` written out:
the gradient's values are clipped to [-c, c] before Adam. Images are read
and written through volren_tpu_torch.utils.image (8-bit PNGs), and the
resize is jax.image.resize's antialiased bicubic. ``--noise`` starts from
numpy's ``default_rng(0)`` uniforms where the JAX script draws
``jax.random.uniform``. It runs on the card unless ``--device cpu``
(``--cpu``).
"""

import argparse
import glob
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.image import read_png, write_png

# VGG11 'features' architecture: conv(out_ch) / M = maxpool
VGG11_CFG = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]
ADAM_EPS = 1e-8   # optax.scale_by_adam's eps


def random_vgg11_params(seed=0):
    """He-normal VGG11 filters and zero biases, drawn as the JAX script
    draws them."""
    rng = np.random.default_rng(seed)
    params = []
    in_ch = 3
    for v in VGG11_CFG:
        if v == "M":
            continue
        fan_in = in_ch * 9
        w = rng.normal(0, np.sqrt(2.0 / fan_in), size=(v, in_ch, 3, 3)).astype(np.float32)
        params.append((torch.from_numpy(w), torch.zeros(v)))
        in_ch = v
    return params


def load_vgg11_params(seed=0):
    """Conv weights from a cached torchvision VGG11 checkpoint if one is
    there, else He-initialised random filters."""
    cached = glob.glob(os.path.join(torch.hub.get_dir(), "checkpoints", "vgg11-*.pth"))
    if cached:
        state = torch.load(cached[0], map_location="cpu")
        convs = sorted({int(k.split(".")[1]) for k in state
                        if k.startswith("features.") and k.endswith(".weight")})
        print("using pretrained VGG11 features")
        return [(state[f"features.{i}.weight"].float(), state[f"features.{i}.bias"].float())
                for i in convs]
    print("pretrained VGG11 unavailable (no cached vgg11 checkpoint); using random features")
    return random_vgg11_params(seed)


def vgg_features(params, x):
    """x: (1, 3, H, W). Returns post-ReLU activations of every conv."""
    feats = []
    pi = 0
    for v in VGG11_CFG:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        w, b = params[pi]
        pi += 1
        x = F.relu(F.conv2d(x, w, b, padding=1))
        feats.append(x)
    return feats


def l2(a, b):
    return torch.mean((a - b) ** 2)


def smape(a, b):
    return torch.mean(torch.abs(a - b) / (torch.abs(a) + torch.abs(b) + 0.1))


def gram_matrix(x):
    b, c, h, w = x.shape
    t = x.reshape(b * c, h * w)
    return (t @ t.T) / (b * c * h * w)


def style_loss_fn(params, image, content, style, content_weight, style_weight,
                  feats_c=None, feats_s=None):
    mask = torch.where(content > 0, 1.0, 0.0)
    feats_i = vgg_features(params, mask * image)
    feats_c = vgg_features(params, content) if feats_c is None else feats_c
    feats_s = vgg_features(params, style) if feats_s is None else feats_s
    feature_loss = 0.0
    style_loss = 0.0
    for fi, fc, fs in zip(feats_i, feats_c, feats_s):
        feature_loss += content_weight * l2(fi, fc)
        style_loss += style_weight * smape(gram_matrix(fi), gram_matrix(fs))
    return (feature_loss + style_loss) / len(feats_i)


def load_image(path, device="cpu"):
    img = read_png(path)
    img = np.repeat(img[..., :1], 3, axis=-1) if img.shape[-1] < 3 else img[..., :3]
    img = img.astype(np.float32) / 255.0
    return torch.from_numpy(img.transpose(2, 0, 1)[None].copy()).to(device)  # (1, 3, H, W)


def _keys_cubic(x):
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of jax.image.resize's antialiased "bicubic"
    (Keys, a = -0.5) along one axis (jax.image.scale.compute_weight_mat)."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def resize(img, size):
    """jax.image.resize(img, (1, 3, H, W), "bicubic"): each axis whose size
    changes goes through its weight matrix; an unchanged axis is kept."""
    h, w = size
    if img.shape[2] != h:
        wy = torch.from_numpy(_bicubic_weights(img.shape[2], h)).to(img.device)
        img = torch.einsum("bchw,hy->bcyw", img, wy)
    if img.shape[3] != w:
        wx = torch.from_numpy(_bicubic_weights(img.shape[3], w)).to(img.device)
        img = torch.einsum("bchw,wx->bchx", img, wx)
    return img


class ClippedAdam:
    """optax.chain(clip(c), scale_by_adam(b1, b2),
    scale_by_learning_rate(exponential_decay(lr, 1, gamma))) on one tensor:
    ``update(grad)`` returns the step to add to the image."""

    def __init__(self, like, lr, b1, b2, clip, gamma):
        self.lr, self.b1, self.b2, self.clip, self.gamma = lr, b1, b2, clip, gamma
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)
        self.count = 0

    def update(self, grad):
        g = torch.clamp(grad, -self.clip, self.clip)
        self.mu = self.b1 * self.mu + (1.0 - self.b1) * g
        self.nu = self.b2 * self.nu + (1.0 - self.b2) * g * g
        lr = self.lr * self.gamma ** self.count     # the schedule at the count before
        self.count += 1
        mu_hat = self.mu / (1.0 - self.b1 ** self.count)
        nu_hat = self.nu / (1.0 - self.b2 ** self.count)
        return -lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))


def main(argv=None):
    p = argparse.ArgumentParser(description="Neural style transfer (torch)")
    p.add_argument("content_path")
    p.add_argument("style_path")
    p.add_argument("-e", "--epochs", type=int, default=1000)
    p.add_argument("-lr", "--learning_rate", type=float, default=0.1)
    p.add_argument("-b1", "--beta1", type=float, default=0.9)
    p.add_argument("-b2", "--beta2", type=float, default=0.999)
    p.add_argument("-c", "--clip", type=float, default=1.0)
    p.add_argument("-g", "--gamma", type=float, default=0.999)
    p.add_argument("--save_epochs", type=int, default=50)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--content", type=float, default=1.0)
    p.add_argument("--style", type=float, default=3000.0)
    p.add_argument("--noise", action="store_true")
    p.add_argument("--output", default="styletransfer.png")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    args = p.parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)

    content = load_image(args.content_path, device)
    style = load_image(args.style_path, device)
    scale = min(1.0, args.image_size / max(content.shape))
    h = int(content.shape[2] * scale)
    w = int(content.shape[3] * scale)
    content = resize(content, (h, w))
    style = resize(style, (h, w))

    params = [(wt.to(device), b.to(device)) for wt, b in load_vgg11_params()]
    if args.noise:
        noise = np.random.default_rng(0).random(tuple(content.shape), np.float32)
        image = torch.from_numpy(noise).to(device) * torch.where(content > 0, 1.0, 0.0)
    else:
        image = content.clone()

    opt = ClippedAdam(image, args.learning_rate, args.beta1, args.beta2, args.clip, args.gamma)
    with torch.no_grad():
        feats_c = vgg_features(params, content)
        feats_s = vgg_features(params, style)

    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        image = image.detach().requires_grad_(True)
        loss = style_loss_fn(params, image, content, style, args.content, args.style,
                             feats_c, feats_s)
        (grad,) = torch.autograd.grad(loss, image)
        with torch.no_grad():
            image = torch.clamp(image + opt.update(grad), 0.0, 1.0)
        max_grad = float(grad.abs().max())
        if epoch % args.save_epochs == 0 or epoch == args.epochs:
            out = image[0].detach().cpu().numpy().transpose(1, 2, 0)
            write_png(args.output, (np.clip(out, 0, 1) * 255).astype(np.uint8))
        dt = time.time() - t0
        print(
            f"Train epoch {epoch:04}: loss: {float(loss.detach()):3.6f}, "
            f"max grad: {max_grad:4.4f}, time: {dt * 1000:.0f}ms",
            end="\r",
        )
    print("")
    print(f"{args.output} written.")
    return image.detach()


if __name__ == "__main__":
    main()
