"""Neural models (volren_tpu.models): the UNet denoiser trained on the
noisy / converged pairs of ``scripts.datagen_denoise``."""

from .denoiser import Denoiser, create_train_state, denoise_image, train_step

__all__ = ["Denoiser", "create_train_state", "denoise_image", "train_step"]
