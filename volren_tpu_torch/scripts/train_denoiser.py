"""Train the UNet denoiser on a datagen_denoise dataset (the port of
scripts/train_denoiser.py).

Usage:
    python -m volren_tpu_torch.scripts.datagen_denoise      # dataset_{input,target}.npz
    python -m volren_tpu_torch.scripts.train_denoiser dataset_input.npz dataset_target.npz

Random patches are drawn from the fp16 (N, 3, H, W) ``color`` pairs (an
``.npz``, or an ``.h5`` when h5py is importable) with numpy's generator
seeded 0, as the JAX script draws them; training runs on the card (bf16
convolutions) unless ``--device cpu``. The parameters are written in
volren_tpu's pickle layout (``models.denoiser.save_params``), every 500
steps and at the end; ``--resume`` starts from such a file, from either
package.
"""

import argparse
import time

import numpy as np

from ..models.denoiser import (create_train_state, from_flax_params, load_params,
                               save_params, train_step)


def load_color(path: str):
    """The ``color`` array of a dataset file (.npz, or .h5 with h5py)."""
    if path.endswith(".h5"):
        try:
            import h5py
        except ImportError as e:
            raise SystemExit(f"{path}: reading .h5 needs h5py; use the .npz datasets") from e
        return h5py.File(path, "r")["color"]
    with np.load(path) as f:
        return f["color"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("input_data", help="noisy renders (.npz or .h5)")
    p.add_argument("target_data", help="converged renders (.npz or .h5)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--patch", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--output", default="denoiser_params.pkl")
    p.add_argument("--resume", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    fin = load_color(args.input_data)
    ftg = load_color(args.target_data)
    n, _, h, w = fin.shape
    print(f"dataset: {n} pairs at {w}x{h}")

    rng = np.random.default_rng(0)
    model, opt, sched = create_train_state(0, lr=args.lr, patch=args.patch, device=args.device)
    if args.resume:
        model.load_state_dict(from_flax_params(load_params(args.resume), model))

    def batch():
        idx = rng.integers(0, n, args.batch)
        ys = rng.integers(0, h - args.patch + 1, args.batch)
        xs = rng.integers(0, w - args.patch + 1, args.batch)
        noisy = np.stack(
            [fin[i, :, y: y + args.patch, x: x + args.patch] for i, y, x in zip(idx, ys, xs)]
        ).astype(np.float32)
        clean = np.stack(
            [ftg[i, :, y: y + args.patch, x: x + args.patch] for i, y, x in zip(idx, ys, xs)]
        ).astype(np.float32)
        return noisy, clean

    t0 = time.time()
    for step in range(1, args.steps + 1):
        noisy, clean = batch()
        loss = train_step(model, opt, sched, noisy, clean)
        if step % 50 == 0 or step == 1:
            print(
                f"step {step:5d}: loss {float(loss):.5f} "
                f"({step / (time.time() - t0):.1f} it/s)",
                flush=True,
            )
        if step % 500 == 0:
            save_params(args.output, model)
    save_params(args.output, model)
    print(f"{args.output} written.")


if __name__ == "__main__":
    main()
