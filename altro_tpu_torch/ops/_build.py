"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own nvcc process, all started
together, for ``sm_90a``; one more nvcc call links the objects into one
shared library with a plain C interface, loaded with ctypes. The library is
built at first use into ``build/altro_tpu_torch/<hash>/`` under the
repository root (listed in .gitignore), keyed by a hash of the sources and
flags, so a fresh checkout builds everything from its own sources and later
calls reuse the build. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "altro_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libaltro_tpu_torch_kernels.so"

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of the entry points; every pointer and the stream is c_void_p.
# A block table is (int count, int* meta, void** multiplier pointers).
_TABLE = [_I, _P, _P]
_SIGNATURES = {
    "altro_ls_rollout_f32": [_P] * 3 + [_I] + [_P] * 5 + [_I] + [_P] * 2
                            + [_I] * 4 + [_P],
    "altro_fused_expand_backward_f32": [_P] * 11 + _TABLE + [_P] * 8
                                       + [_I] * 5 + [_P],
    "altro_ls_rollout_al_f32": [_P] * 13 + _TABLE + [_P] * 6 + [_I]
                               + [_P] * 3 + [_I] * 5 + [_P],
    "altro_riccati_f32": [_P] * 2 + [_I] + [_P] * 10 + [_I] * 4 + [_P],
}
for _name in list(_SIGNATURES):
    _SIGNATURES[_name.replace("_f32", "_f64")] = _SIGNATURES[_name]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    """Directory of the build for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the
    library path. A failed build raises with nvcc's output."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.suffix == ".cu"]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu), "-o",
             str(out_dir / (cu.stem + ".o"))] for cu in cus]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    log, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(log[-1])
    if not failed:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", tmp, *(c[-1] for c in cmds)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(log[-1])
            os.unlink(tmp)
    (out_dir / "build.log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(failed))
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """nvcc's output of the current build (ptxas register and shared-memory
    use per kernel), or '' before the first build."""
    log = build_dir() / "build.log"
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
