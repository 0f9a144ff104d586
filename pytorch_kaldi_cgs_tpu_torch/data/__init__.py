"""Chunk layout types (file loading comes with the pipeline slice)."""
