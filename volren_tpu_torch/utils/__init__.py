"""Image IO: Radiance .hdr read/write and PNG output."""
