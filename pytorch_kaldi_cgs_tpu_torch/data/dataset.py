"""Chunk layout: the port's copy of the dataclasses of the JAX package's
``data/dataset.py`` (``FeaStream``, ``LabStream``, ``ChunkData``).

All feature streams and then all label streams are column-stacked into
one ``(total_frames, sum(dims) + n_labs)`` float matrix; ``end_index``
holds cumulative sentence end rows; each feature stream records its
column range ``[col_start, col_end)``, each label its column. Loading
a chunk from Kaldi files (``load_chunk_multi``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class FeaStream:
    """One feature stream of a dataset (one fea_name block in the cfg)."""
    name: str
    fea_lst: str
    fea_opts: str = ""
    cw_left: int = 0
    cw_right: int = 0
    col_start: int = -1              # [col_start, col_end) in ChunkData.data
    col_end: int = -1


@dataclass
class LabStream:
    """One label stream (one lab_name block in the cfg)."""
    name: str
    lab_folder: str
    lab_opts: str = "ali-to-pdf"
    lab_count_file: str = "auto"
    lab_data_folder: str = ""
    lab_graph: str = ""
    col: int = -1


@dataclass
class ChunkData:
    """One loaded chunk: the concatenated frame matrix plus stream layout."""
    names: List[str]
    data: np.ndarray                 # (frames, fea_cols + n_labs)
    end_index: np.ndarray            # cumulative sentence ends
    fea_streams: Dict[str, FeaStream] = field(default_factory=dict)
    lab_streams: Dict[str, LabStream] = field(default_factory=dict)

    @property
    def seq_lengths(self) -> np.ndarray:
        prev = np.concatenate([[0], self.end_index[:-1]])
        return self.end_index - prev
