"""Scene description on the host: camera, environment map, transfer function."""
