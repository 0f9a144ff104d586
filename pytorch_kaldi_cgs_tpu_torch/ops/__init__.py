"""Kernels (CUDA sources under ``csrc/``) with their plain twins, and the
fbank/MFCC frontend. Exports the JAX package's ``ops`` names where the
port has them; ``add_deltas`` and ``cmvn`` are the counterparts of its
``add_deltas_jax`` and ``cmvn_jax``."""

from .block_sparse import (BlockLayout, block_sparse_matmul,
                           block_sparse_matmul_xla, pack_blocks, pack_layout,
                           unpack_blocks)
from .frontend import Frontend, add_deltas, cmvn

__all__ = ["BlockLayout", "pack_layout", "pack_blocks", "unpack_blocks",
           "block_sparse_matmul", "block_sparse_matmul_xla", "Frontend",
           "add_deltas", "cmvn"]
