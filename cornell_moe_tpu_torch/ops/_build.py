"""Build and load the CUDA kernel library (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library with a plain C
interface, loaded through ``ctypes``.  The library lands in ``csrc/build/``
under a name carrying a hash of the sources, so an edit to any source
rebuilds it and an unchanged tree reuses it.  What ``ptxas -v`` says of each
kernel (registers, spills, shared memory) is kept beside the library
(:func:`ptxas_report`).  A missing ``nvcc`` or a failed build raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    "cmoe_covariance_with_noise": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cmoe_lml_fused_cluster": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P],
    "cmoe_lml_fused_cluster_smem_bytes": [_I],
    "cmoe_lml_fused_cluster_occupancy": [_I, _I, _I, _IP],
    "cmoe_lml_fused_global": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _P],
    "cmoe_lml_fused_global_smem_bytes": [_I],
    "cmoe_lml_fused_global_scratch_floats": [_I],
    "cmoe_lml_fused_global_occupancy": [_I, _I, _IP],
    "cmoe_lml_fused_cluster_f64": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _P],
    "cmoe_lml_fused_cluster_smem_bytes_f64": [_I],
    "cmoe_lml_fused_global_f64": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _P],
    "cmoe_lml_fused_global_smem_bytes_f64": [_I],
    "cmoe_lml_fused_global_scratch_f64": [_I],
    "cmoe_lml_fused_global_occupancy_f64": [_I, _I, _IP],
    "cmoe_lml_chol_f64": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _P],
    "cmoe_descent_run_mma": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P],
    "cmoe_descent_run_mma_smem_bytes": [_I, _I, _I],
    "cmoe_descent_run_mma_occupancy": [_I, _I, _I, _I, _I, _IP],
    "cmoe_descent_run_fma": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P],
    "cmoe_descent_grad_mma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P],
    "cmoe_descent_grad_fma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P],
}

_lib = None
build_seconds = None     # wall time of the last compile (None: reused)


def sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "cornell_moe_tpu_torch cannot be built")
    return nvcc


def _target() -> Path:
    return BUILD_DIR / f"libcornell_moe_kernels_{source_hash()}.so"


def ptxas_report() -> dict:
    """Per kernel entry (mangled name) of the built library: registers,
    spill stores and loads (bytes), from ``ptxas -v``."""
    report, entry = {}, None
    for line in _target().with_suffix(".ptxas.txt").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            report[entry] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            report[entry].update(spill_stores=int(m.group(1)),
                                 spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            report[entry]["registers"] = int(m.group(1))
    return report


def build(force: bool = False) -> Path:
    """Compile the library if the sources changed; returns its path."""
    global build_seconds
    target = _target()
    if target.exists() and not force:
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        jobs = []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed, ptxas = [], []
        for cmd, _, proc in jobs:
            out, err = proc.communicate()
            ptxas.append(err)
            if proc.returncode != 0:
                failed.append((cmd, proc.returncode, out, err))
        if not failed:
            lib = os.path.join(work, "lib.so")
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
                   *[obj for _, obj, _ in jobs]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                failed = [(cmd, proc.returncode, proc.stdout, proc.stderr)]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"({rc}) {' '.join(cmd)}\n{out}\n{err}"
                for cmd, rc, out, err in failed))
        target.with_suffix(".ptxas.txt").write_text("".join(ptxas))
        os.replace(lib, target)
    build_seconds = time.time() - t0
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
