"""OpenVDB (.vdb) IO — implemented in vdb_reader.py, re-exported here."""

from .vdb_reader import read_vdb, write_vdb, write_vdb_grids

__all__ = ["read_vdb", "write_vdb", "write_vdb_grids"]
