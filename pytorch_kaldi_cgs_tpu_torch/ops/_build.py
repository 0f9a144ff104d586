"""Build the hand-written CUDA kernels with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own into ``build/torch_kernels/lib<name>-<hash>.so`` of the checkout,
at first use, then loaded with ``ctypes``. The file name carries a hash
of the source and of the shared headers (``csrc/*.cuh``), so an edited
source is rebuilt. Several sources build in parallel (one ``nvcc``
each; :data:`SOURCES` names them all). A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: Every kernel source of the port, for building them all at once.
SOURCES = ("fused_lstm_fwd", "fused_lstm_bwd", "fused_lstm_sparse",
           "block_sparse_dw", "fused_ligru", "block_sparse_v3",
           "fused_gru_sparse", "fused_gru", "fused_rnn", "fused_ligru_sparse",
           "fused_gru_torch", "fused_rnn_sparse", "block_sparse_legacy",
           "block_sparse_dx")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / (name + ".cu")).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest))


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every source not built yet, all at once; returns each
    name's compiler output (``-Xptxas -v``: registers, shared memory,
    spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(".so.tmp%d" % os.getpid())
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s.cu:\n%s" % (name, log))
        os.replace(tmp, out)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        lib.pk_error_string.argtypes = [ctypes.c_int]
        lib.pk_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C launcher."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d (%s)" % (
            what, rc, lib.pk_error_string(rc).decode()))
