"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source `csrc/<name>.cu` exposes a plain C interface and compiles on its
own into `build/kernels/lib<name>-<digest>.so` at the repository root (a
directory git ignores). The digest covers the source, the shared headers
`csrc/*.cuh` and the flags, so an edited source or header is rebuilt and
never served from a stale library. A caller may add `-D` defines, which
make a library of their own (attention_qkv3.cu's two-step-only build,
chip_smoke.py's yardstick of its cluster epilogue). Nothing is
built when a module is imported: the first launch builds, or a caller that
wants the build timed on its own calls `build()` first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("attention_qkv3", "ln_quant", "fused_mlp_int8", "act_quant",
           "attention_f32", "epilogue", "int8_epilogue", "int8_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME or in "
                           "/usr/local/cuda: the CUDA kernels cannot be built")
    return str(path)


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES, defines: tuple[str, ...] = ()) -> dict[str, str]:
    """Compile every named source whose library is missing, one nvcc process
    per source, all started together, with `defines` (`-DNAME=value`) added
    to the flags. Returns each compiled source's nvcc output (register and
    shared-memory use from ptxas); raises on failure."""
    todo = [n for n in names if not library_path(n, defines).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name in todo:
            out = library_path(name, defines)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        logs = {}
        for name, (proc, tmp, out) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n{logs[name]}")
            os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
        return logs
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` built with `defines`, built
    first if needed."""
    lib = _loaded.get((name, defines))
    if lib is None:
        build([name], defines)
        lib = ctypes.CDLL(str(library_path(name, defines)))
        lib.hirest_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hirest_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name, defines] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.hirest_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
