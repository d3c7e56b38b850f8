"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Every ``.cu`` file under ``diffsvc_tpu_torch/csrc`` is compiled by its own
``nvcc`` for ``sm_90a`` (all started together), and the objects are linked
into ONE shared library with a plain C interface, loaded with ``ctypes``.
The library goes to ``build/diffsvc_tpu_torch/<hash>/`` at the
repository root, keyed by a hash of the sources and the flags, so a fresh
checkout builds at first use and an unchanged tree reuses its build.

Nothing here runs at import time: the CPU tests import every module, and a
machine without a card or ``nvcc`` must still import the package.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "diffsvc_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the nvcc build (None = reused)
build_log: str = ""                  # nvcc/ptxas output of the last build

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

# C entry points: name -> argtypes (all return int = cudaError_t)
SIGNATURES = {
    # diffnet_stack.cu
    "dsvc_residual_stack": [I, P, P, P, P, LL, LL, P, P, P, P, P,
                            I, I, I, I, I, P, P, P],
    # diffnet_stack_train.cu
    "dsvc_stack_train_fwd": [I, I, P, P, P, P, P, P, LL, LL, P, P, P, P, P,
                             I, I, I, I, I, P, P],
    "dsvc_stack_train_bwd": [I, *[P] * 27, I, I, I, I, I, I, I, P, P],
    # diffnet_stack_per_sample.cu
    "dsvc_stack_train_bwd_per_sample": [I, *[P] * 28, I, I, I, I, I, I, I, P,
                                        P],
    # diffnet_block.cu
    "dsvc_residual_block": [I, *[P] * 11, I, I, I, I, P, P],
    # plms_ladder.cu
    "dsvc_plms_ladder": [I, *[P] * 20, I, I, I, I, I, I, I, F, P, P],
    # vocoder_tail.cu
    "dsvc_tail_conv": [P, P, P, P, P, P, I, F, I, I, I, I, F, I, P, P],
    "dsvc_tail_convt": [P, P, P, P, I, P, I, I, I, I, I, I, I, F, P, P],
    "dsvc_tail_pair": [P, P, P, P, P, P, P, I, F, I, I, I, F, P, P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the Hopper kernels are built from "
                           "diffsvc_tpu_torch/csrc at first use and need the "
                           "CUDA toolkit")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in _sources():
        h.update(os.path.basename(fn).encode())
        with open(fn, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_ROOT, _source_hash(), "libdsvc_hopper.so")


def build() -> str:
    """Compile the kernels unless a build of these exact sources exists.
    Returns the library path; raises with nvcc's output on failure."""
    global build_seconds, build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cus = [fn for fn in _sources() if fn.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(fn)}.o" for fn in cus]
    t0 = time.time()
    try:
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-c",
                                   "-o", obj, fn], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for fn, obj in zip(cus, objs)]
        build_log = "".join(f"== {os.path.basename(fn)}\n{p.communicate()[0]}"
                            for fn, p in zip(cus, procs))
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               tmp, *objs],
                              capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{build_log}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(os.path.join(os.path.dirname(out), "build.log"), "w") as f:
        f.write(build_log)
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    build_seconds = time.time() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.dsvc_error_string.argtypes = [ctypes.c_int]
            handle.dsvc_error_string.restype = ctypes.c_char_p
            _LIB = handle
    return _LIB


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib().dsvc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for an absent optional operand)."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
