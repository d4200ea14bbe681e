"""Scene description on the host: camera and environment map."""
