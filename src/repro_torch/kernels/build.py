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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("filter_count.cu", "groupby_agg.cu", "hash_probe.cu",
           "join_expand.cu", "topk.cu", "decode_attention.cu", "errors.cu")
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "repro_filter_mask_counts": (_P, _P, _P, _P, _P, _I64, _I32, _P),
    "repro_groupby_sum": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32,
                          _I64, _I32, _I32, _I32, _I32, _I32, _I32, _P),
    "repro_hash_probe": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _P),
    "repro_join_expand": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                          _I32, _P, _P, ctypes.c_uint64, ctypes.c_uint32, _P),
    "repro_topk_select": (_P, _I64, _I32, _I32, _P, _P, _P),
    "repro_topk_select64": (_P, _I64, _I32, _I32, _P, _P, _P),
    "repro_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                               _I32, _I32, _I32, _I32, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_entries: dict = {}   # kernel name -> its bound entry point, once loaded
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
                _entries[name[len("repro_"):]] = fn
            dll.repro_cuda_error_string.argtypes = [ctypes.c_int]
            dll.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = dll
        return _lib


def launch(name: str, index: int, stream: int, *args) -> None:
    """Call the entry point ``repro_<name>(*args, stream)`` with CUDA device
    ``index`` current (entered only when it is not already), raise if it
    returns a CUDA error, and count the launch."""
    fn = _entries.get(name)
    if fn is None:
        lib()
        fn = _entries[name]
    if torch.cuda.current_device() == index:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        msg = lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    count_launch(COUNTED_AS.get(name, name))


# ---------------------------------------------------------------------------
# launch counts: ``launch`` adds one where a wrapper launches its kernel, so
# a count is of wrapper calls that reached the card.  A call may run more than
# one grid: topk_select's rounds (one while n <= 1024 keys, as on the
# ClickBench path, more above that).
# ---------------------------------------------------------------------------

KERNELS = ("filter_mask_counts", "groupby_sum", "hash_probe", "join_expand",
           "topk_select", "decode_attention")
# entry points counted under another kernel's name: topk_select's int64 keys
COUNTED_AS = {"topk_select64": "topk_select"}
_counts_lock = threading.Lock()
_launches = {k: 0 for k in KERNELS}


def count_launch(name: str) -> None:
    with _counts_lock:
        _launches[name] += 1


def add_launch_counts(counts: dict) -> None:
    """Add per-kernel launches made outside ``launch``: those a replayed
    CUDA graph holds (negative to take back what a capture counted)."""
    with _counts_lock:
        for k, n in counts.items():
            _launches[k] += n


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

    All on one CUDA device makes it False; any other device, or a mix,
    raises."""
    if all(t.is_cpu for t in tensors):
        return True
    index = tensors[0].get_device()
    if all(t.is_cuda and t.get_device() == index for t in tensors):
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


def current_stream(index: int) -> int:
    """Handle (cudaStream_t) of PyTorch's current stream on CUDA device
    ``index``: what ``torch.cuda.current_stream(index).cuda_stream`` gives,
    without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(index)


_sm_counts: dict = {}


def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n
