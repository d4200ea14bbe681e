"""volren_tpu_torch — the PyTorch/CUDA port of volren_tpu.

The JAX package ``volren_tpu`` stays the reference; this package renders
its main path (a no-TF, no-emission brick-grid density volume under an
HDR environment map) with torch on the host and one hand-written CUDA
kernel on an NVIDIA Hopper card. It imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
