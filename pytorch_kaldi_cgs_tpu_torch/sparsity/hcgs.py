"""HCGS — Hierarchical Coarse-Grain Sparsity mask generators (seeded numpy).

The port's own copy of ``pytorch_kaldi_cgs_tpu/sparsity/hcgs.py``: the
same RNG calls in the same order, so one ``np.random.RandomState`` gives
the same masks in both packages.

  * level l partitions the matrix into ``block_sizes[l]``-square blocks;
  * per block-row, ``max(1, round(n_block_cols * (1 - drop%/100)))``
    column blocks are kept — uniformly at random (HCGS) or the top-k
    blocks by mean |W| (guided HCGS);
  * each surviving block recursively receives the next level's mask;
    when levels are exhausted the block is dense.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _keep_count(n_blocks: int, drop_ratio: float) -> int:
    """Kept blocks per row at one level, clamped to >= 1: without the
    clamp a narrow input under a large level-1 drop rounds to zero kept
    blocks and the layer never sees its input."""
    return max(1, int(round(n_blocks * (1.0 - drop_ratio / 100.0))))


def _block_grid(n: int, block: int) -> int:
    return n // block + (1 if n % block else 0)


def hcgs_mask(n_rows: int, n_cols: int, block_sizes: Sequence[int],
              drop_ratios: Sequence[float],
              rng: np.random.RandomState | None = None,
              seed: int | None = None) -> np.ndarray:
    """Random hierarchical block mask of shape ``(n_rows, n_cols)``;
    selection is per row block across column blocks."""
    if len(block_sizes) != len(drop_ratios):
        raise ValueError("block_sizes and drop_ratios must have equal length")
    if rng is None:
        rng = np.random.RandomState(seed)
    return _level_mask(n_rows, n_cols, list(block_sizes), list(drop_ratios),
                       rng, None)


def guided_hcgs_mask(weight: np.ndarray, block_sizes: Sequence[int],
                     drop_ratios: Sequence[float],
                     rng: np.random.RandomState | None = None,
                     seed: int | None = None) -> np.ndarray:
    """Weight-magnitude-guided hierarchical block mask shaped like
    ``weight``: per row block, keep the top-k column blocks by mean |W|."""
    if rng is None:
        rng = np.random.RandomState(seed)
    w = np.abs(np.asarray(weight, dtype=np.float64))
    return _level_mask(w.shape[0], w.shape[1], list(block_sizes),
                       list(drop_ratios), rng, w)


def _level_mask(n_rows: int, n_cols: int, blocks: list, drops: list,
                rng: np.random.RandomState, guide: np.ndarray | None
                ) -> np.ndarray:
    if not blocks:
        return np.ones((n_rows, n_cols), dtype=np.float32)
    block = blocks[0]
    drop = drops[0]
    n_blk_rows = _block_grid(n_rows, block)
    n_blk_cols = _block_grid(n_cols, block)
    n_keep = _keep_count(n_blk_cols, drop)
    mask = np.zeros((n_rows, n_cols), dtype=np.float32)
    for bi in range(n_blk_rows):
        r0, r1 = bi * block, min((bi + 1) * block, n_rows)
        if guide is None:
            chosen = rng.choice(n_blk_cols, n_keep, replace=False)
        else:
            chosen = _top_blocks_by_mean(guide[r0:r1], block, n_blk_cols,
                                         n_keep)
        for bj in chosen:
            c0, c1 = bj * block, min((bj + 1) * block, n_cols)
            sub_guide = guide[r0:r1, c0:c1] if guide is not None else None
            mask[r0:r1, c0:c1] = _level_mask(r1 - r0, c1 - c0, blocks[1:],
                                             drops[1:], rng, sub_guide)
    return mask


def _top_blocks_by_mean(row_band: np.ndarray, block: int, n_blk_cols: int,
                        n_keep: int) -> np.ndarray:
    """Mean |W| per column block of one row band -> indices of the top
    ``n_keep``."""
    scores = np.empty(n_blk_cols, dtype=np.float64)
    for bj in range(n_blk_cols):
        c0, c1 = bj * block, min((bj + 1) * block, row_band.shape[1])
        scores[bj] = row_band[:, c0:c1].mean()
    return np.argsort(scores, kind="stable")[-n_keep:]
