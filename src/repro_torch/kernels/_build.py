"""Build and load the port's hand-written CUDA kernels.

Every kernel lives in ``src/repro_torch/csrc/*.cu`` behind a plain C
interface.  At first use, :func:`lib` compiles each source with ``nvcc``
for ``sm_90a`` (one ``nvcc`` process per source, all started together),
links them into one shared library under ``build/repro_torch/`` at the
root of the checkout — named by a hash of the sources and flags, so an
edited source rebuilds — and loads it with ``ctypes``.  Nothing is built
when a module is imported: the CPU tests import every module and have no
``nvcc``.

The wrappers in ``repro_torch.kernels.*`` call the C entry points with
``data_ptr()`` integers and the current stream's handle, and raise when
the returned ``cudaError_t`` is not 0.
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, kpos, out, B, Sq, S, Hq, Hkv, q_offset, window, scale, stream
    "flash_prefill_bf16": [_P] * 5 + [_I] * 7 + [ctypes.c_float, _P],
    # q, k, v, kpos, out, B, S, Hq, Hkv, q_pos, window, scale, stream
    "flash_decode_bf16": [_P] * 5 + [_I] * 6 + [ctypes.c_float, _P],
    # nf, caches*, staged*, scales*, chans*, S, T, t0, slot_lo, n_slots,
    # rows, cs, dtype, stream
    "kv_restore": [_I, _P, _P, _P, _P] + [_I] * 8 + [_P],
    # x, amax, q, scales, R, C, dtype, stream
    "kv_quantize": [_P] * 4 + [_I] * 3 + [_P],
    # q, scales, out, R, C, dtype, stream
    "kv_dequantize": [_P] * 3 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are compiled from src/repro_torch/csrc")
    return found


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels unless this exact build exists; returns
    the shared library's path.  The ptxas report (registers, shared memory,
    spills of every kernel) lands beside it as ``<name>.log``."""
    cus = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"libreprotorch_{_digest(sorted(CSRC.glob('*.cu*')))}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for cu in cus:
            obj = Path(tmp) / (cu.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(cu), "-o",
                   str(obj)]
            procs.append((cu, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cu, _obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {cu.name}\n{text}")
            if proc.returncode != 0:
                failed.append(cu.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(so)]
            + [str(o) for _cu, o, _p in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(so, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def require_cuda(name: str, *tensors: torch.Tensor):
    """The kernel takes contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device "
                             f"(got {t.device} and {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
