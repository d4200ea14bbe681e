"""The repo's scripts on the port, each run as ``python -m
volren_tpu_torch.scripts.<name>`` with the JAX script's flags:
``colmap_model`` (COLMAP model I/O), ``make_cloud`` (a procedural cumulus
.brick), ``compare_rmse`` (RMSE / PSNR of two renders), ``datagen_denoise``
and ``datagen_colmap`` (datasets rendered through ``volren_tpu_torch.volpy``),
``train_denoiser`` (the UNet on a datagen_denoise dataset) and
``styletransfer`` (neural style transfer on VGG11 features).

Differences from the JAX scripts: datasets are ``.npz`` files holding
``color`` (N, 3, H, W) fp16 (``train_denoiser`` also reads ``.h5`` when h5py
is importable); images are read and written through
``volren_tpu_torch.utils.image``; the datagen scripts render the in-repo
``.scene_cache/cloud512.brick`` under ``procedural_sky`` by default and take
their settings as flags, not ``DATAGEN_*`` environment variables.
"""
