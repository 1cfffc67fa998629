"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one source in `csrc/` with a plain C entry point, built on
first use, for `sm_90a`, into its own shared library in `build/repro_torch/`
at the root of the checkout.  A library's file name carries a hash of its
source and the flags: an unchanged source is not rebuilt.  Nothing but the
sources in the repository goes into the build.  `build()` starts one nvcc
for each source that is not built yet, all together, and waits for them.
Building needs `nvcc` (`CUDA_HOME`, then `/usr/local/cuda`, then `PATH`); a
failed build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention", "mamba_scan", "rglru_scan", "mamba_step")
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


def source(name: str) -> Path:
    if name not in SOURCES:
        raise KeyError(f"no kernel source {name!r}; sources: {SOURCES}")
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile the named sources (all of them by default) unless they are
    built already; return each one's library.

    nvcc's report (`-Xptxas -v`: registers, spills and shared memory of each
    kernel instance) is kept beside each library as `<name>.log`.
    """
    names = names or SOURCES
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = {n: out[n].with_suffix(f".{os.getpid()}.tmp") for n in todo}
    procs = {n: subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp[n]), str(source(n))],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for n in todo}
    failed = []
    for n, proc in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp[n].unlink(missing_ok=True)
            failed.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):\n{stderr}")
            continue
        out[n].with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp[n], out[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The built library of one source, loaded once."""
    return ctypes.CDLL(str(build(name)[name]))
