"""Serving: batch and streaming recognizers."""
