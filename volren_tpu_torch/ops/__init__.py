"""Device code in torch: RNG, geometry, phase functions, scene upload,
environment sampling, tonemapping, and the render kernel (ops.kernels)."""
