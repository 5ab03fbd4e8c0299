"""Build the CUDA kernels into one shared library and load it with ctypes.

The sources in ``repro_torch/csrc`` have plain ``extern "C"`` entry points
that return ``cudaError_t``; ``nvcc`` compiles each for ``sm_90a`` (all at
once, one process per source) and links them into one library, named by a
hash of the sources and flags so that an edit rebuilds it.  The build runs
at first use, never at import, into ``build/repro_torch`` at the checkout's
root (or ``$REPRO_TORCH_BUILD_DIR``).  A missing ``nvcc`` or a failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("filter_count.cu", "groupby_agg.cu", "hash_probe.cu",
           "join_expand.cu", "topk.cu", "errors.cu")
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "repro_filter_mask_counts": (_P, _P, _P, _P, _P, _I64, _I32, _P),
    "repro_groupby_sum": (_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P),
    "repro_hash_probe": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _P),
    "repro_join_expand": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    "repro_topk_select": (_P, _I64, _I32, _P, _P, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas register / shared-memory report) and
# how long it took; None when the library came from an earlier build
build_log: Optional[str] = None
build_seconds: Optional[float] = None


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the library if it is not built yet → its path."""
    global build_log, build_seconds
    out = build_dir() / f"librepro_kernels_{_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    work = build_dir() / f"obj_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        obj = work / (src + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src}\n{text}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = work / out.name
    link = subprocess.run(
        [nvcc, "-gencode", ARCH, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use; thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(dll, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            dll.repro_cuda_error_string.argtypes = [ctypes.c_int]
            dll.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = dll
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# launch counts: each wrapper adds one where it launches its kernel, so a
# count is of wrapper calls that reached the card.  A call may run more than
# one grid: groupby_sum's partial and merge passes, and topk_select's rounds
# (one while n <= 1024 keys, as on the ClickBench path, more above that).
# ---------------------------------------------------------------------------

KERNELS = ("filter_mask_counts", "groupby_sum", "hash_probe", "join_expand",
           "topk_select")
_counts_lock = threading.Lock()
_launches = {k: 0 for k in KERNELS}


def count_launch(name: str) -> None:
    with _counts_lock:
        _launches[name] += 1


def launch_counts() -> dict:
    with _counts_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in _launches:
            _launches[k] = 0


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers
# ---------------------------------------------------------------------------


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain-version case).

    A CUDA tensor makes it False; any other device, or a mix, raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"kernel inputs must all be on one CUDA device or on "
                     f"the CPU, got {[str(t.device) for t in tensors]}")


def require(t, name: str, dtype, ndim: int) -> None:
    """Raise unless ``t`` has ``dtype`` and ``ndim`` and is contiguous."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
