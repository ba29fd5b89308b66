"""Build the CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>-<hash>.so`` under
the repository root (``nvcc`` for ``sm_90a``, plain C interface), where the
hash covers the source, the headers it includes and its flags, so an edited
source or header is rebuilt.  A
failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("rasa_gemm", "flash_attention", "ssd_chunk", "fastsim", "jitarb")
#: flags a source adds to NVCC_FLAGS: the simulator's scan and the batcher's
#: whole-trace program round every product before the sum it feeds, as the
#: numpy lane they must equal does (no fused multiply-add)
SOURCE_FLAGS = {"fastsim": ["-fmad=false"], "jitarb": ["-fmad=false"]}
#: headers a source includes: their bytes enter its hash, so an edited
#: header rebuilds every source that includes it
HEADERS = {"fastsim": ["fastsim_step.cuh"], "jitarb": ["fastsim_step.cuh"]}

_loaded: dict[str, ctypes.CDLL] = {}
#: ``-Xptxas -v`` report (registers, shared memory, spills) per fresh build
reports: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path("/usr/local/cuda/bin/nvcc")
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _flags(name: str) -> list[str]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join((CSRC / h).read_bytes() for h in HEADERS.get(name, []))
    tag = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    reports[name] = proc.stderr
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def build_all() -> dict[str, Path]:
    """Build every source at once, one nvcc per source."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def raise_if(err: int, error_string, what: str) -> None:
    """Raise when a launcher returned a CUDA error (``error_string`` is the
    library's ``cudaGetErrorString`` export)."""
    if err != 0:
        raise RuntimeError(f"{what} failed: {error_string(err).decode()} ({err})")
