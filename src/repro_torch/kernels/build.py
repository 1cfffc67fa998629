"""Build the port's CUDA kernel with nvcc and load it with ctypes.

The kernel is one source, `csrc/flash_attention.cu`, with a plain C entry
point.  It is compiled on first use, for `sm_90a`, into `build/repro_torch/`
at the root of the checkout, into a file whose name carries a hash of the
source and the flags: an unchanged source is not rebuilt.  Nothing but the
sources in the repository goes into the build.  Building needs `nvcc`
(`CUDA_HOME`, then `/usr/local/cuda`, then `PATH`); a failed build raises
with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{SOURCE.stem}-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless it is built already; return the library.

    nvcc's report (`-Xptxas -v`: registers, spills and shared memory of each
    kernel instance) is kept beside the library as `<name>.log`.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The built library, loaded once."""
    return ctypes.CDLL(str(build()))
