"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/lib<name>-<hash>.so`` at the repo root (``.gitignore`` lists
``build/``), keyed by a hash of its source, the ``csrc/*.cuh`` headers it
includes and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them. No PyTorch
header is compiled: a library builds in seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NAMES = ("groupnorm_silu", "attention_core", "flash_attention",
         "fused_attention", "mma_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH nor at /usr/local/cuda/bin")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes, directly
    or through another header, in the order first included."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())
                 if (CSRC / inc.decode()).exists()]
    return out


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=NAMES) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` each, all started together. Returns the compiler's output
    (register and shared-memory use from ``-Xptxas -v``) by name; raises
    if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc))
    logs, failed = {}, []
    for name, lib, tmp, proc in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
