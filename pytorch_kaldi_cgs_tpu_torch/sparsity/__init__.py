"""HCGS masks and ceil quantizers."""
