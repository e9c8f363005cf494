"""Build and load the port's CUDA kernels as one shared library.

The sources in ``csrc/`` have a plain C interface; they are compiled with
``nvcc`` for ``sm_90a`` (one ``nvcc`` process per source, all started
together, then one link) into ``build/repro_torch_kernels/<hash>/`` at the
root of the checkout, keyed by a hash of the sources and flags, and loaded
with ``ctypes``. The build happens at first use, never at import. A missing
``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each entry point: pointers, then ints, then the stream
# (fused_topk_l2_slots is a query, not a launch: one int; mma_probe, a
# measurement no route calls, takes its ints first).
SIGNATURES = {
    "gathered_topk": [_P] * 13 + [_I] * 5 + [_P],
    "gathered_topk_quant_int8": [_P] * 15 + [_I] * 5 + [_P],
    "gathered_topk_quant_f16": [_P] * 15 + [_I] * 5 + [_P],
    "gathered_l2": [_P] * 3 + [_I] * 4 + [_P],
    "gathered_l2_dot": [_P] * 3 + [_I] * 4 + [_P],
    "pairwise_l2_masked": [_P] * 8 + [_I] * 4 + [_P],
    "pairwise_l2_masked_f16": [_P] * 8 + [_I] * 4 + [_P],
    "pairwise_l2_int8": [_P] * 10 + [_I] * 4 + [_P],
    "fused_topk_l2": [_P] * 11 + [_I] * 6 + [_P],
    "fused_topk_l2_f16": [_P] * 11 + [_I] * 6 + [_P],
    "fused_topk_l2_slots": [_I],
    "mma_probe": [_I] * 3 + [_P] * 2,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_LOG: Optional[Path] = None


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_sources() + list(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> Path:
    nvcc = find_nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir))
    procs = []
    for src in _sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc={p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    lib_tmp = tmp / LIB_NAME
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp),
         *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    final = out_dir / LIB_NAME
    os.replace(lib_tmp, final)      # atomic: concurrent builders agree
    shutil.rmtree(tmp, ignore_errors=True)
    return final


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / source_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / LIB_NAME
        if not path.exists():
            path = _compile(out_dir)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        BUILD_LOG = out_dir / "build.log"
        _lib = lib
    return _lib
