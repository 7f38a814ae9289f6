"""Build of the port's CUDA kernels: every ``csrc/*.cu`` is compiled the
same way, by ``nvcc`` for sm_90a into a shared library with a plain C
interface, named by a hash of its source, every ``csrc/*.cuh`` header and
the flags, in ``_build/`` beside the package, with nvcc's ptxas report kept
beside it in the ``.log`` of the same name. The wrappers bind the library
with ctypes.

``-fmad=false`` keeps every f32 multiply and add separately rounded, as in
the plain PyTorch versions the kernels are held against.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of ``csrc/<name>.cu``, every header in ``csrc`` (by name and
    content) and the flags: an edit to a shared header rebuilds every
    library."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``_build/<name>-<digest>.so`` (rebuilt
    only when the source, a header or the flags change) and return its
    path."""
    source = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{digest(name)}.so"
    if out.exists() and out.with_suffix(".log").exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_log(name: str) -> str:
    """nvcc's output (the ptxas report) from the build of the current source."""
    return build(name).with_suffix(".log").read_text()
