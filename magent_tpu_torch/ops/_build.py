"""Build and load the port's CUDA kernels.

The sources in ``magent_tpu_torch/csrc/*.cu`` expose a plain C interface.
They are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source,
all started together), linked into ``build/torch_kernels/libmagent_kernels.so``
at the repository root and loaded with ``ctypes``.  Nothing is built at
import: the first CUDA launch builds, so the package imports cleanly on a
machine without ``nvcc``.  A stamp of the sources' and flags' hash skips the
build when the library is current.  Processes that start together (the
ranks of a mesh on one machine) build under a file lock on
``build/torch_kernels/build.lock``: one compiles, the others wait and find
the stamp current.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("gru_cell.cu", "pair_kernels.cu", "seg_kernels.cu", "threefry.cu",
           "window_gather.cu", "window_ladder.cu")
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_PATH = BUILD_DIR / "libmagent_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float
# argtypes of every exported launcher, before the trailing (device index,
# stream) pair; all return a cudaError_t
_SIGNATURES = {
    "magent_occupant": (_P, _P, _P) + (_I,) * 4 + (_P, _P),
    "magent_rank_prefix": (_P, _P, _P) + (_I,) * 4 + (_P,),
    "magent_rank_prefix_hp": (_P,) * 4 + (_I,) * 4 + (_P, _P),
    "magent_move_resolve": (_P, _P, _I, _I, _P, _P, _P),
    "magent_move_claims": (_P,) + (_I,) * 4 + (_P, _P),
    "magent_window_gather": (_P, _P, _P) + (_I,) * 9 + (_P,),
    "magent_window_gather_bf16": (_P, _P, _P) + (_I,) * 9 + (_P,),
    "magent_occupant_rect": (_P,) * 7 + (_I,) * 5 + (_P, _P),
    "magent_rect_first_overlap": (_P,) * 8 + (_I,) * 7 + (_P,),
    "magent_window_gather4": (_P,) * 6 + (_I,) * 9 + (_P,),
    "magent_window_gather4_bf16": (_P,) * 6 + (_I,) * 9 + (_P,),
    "magent_occupant_rect_seg": (_P,) * 10 + (_I,) * 4 + (_P, _P),
    "magent_rect_first_overlap_seg": (_P,) * 11 + (_I,) * 5 + (_P,),
    "magent_rank_prefix_seg": (_P,) * 5 + (_I,) * 4 + (_P,),
    "magent_window_gather_banded": (_P,) * 7 + (_I,) * 9 + (_P,),
    "magent_window_gather_banded_bf16": (_P,) * 7 + (_I,) * 9 + (_P,),
    "magent_window_ladder": (_P,) * 4 + (_I,) * 7 + (_P,),
    "magent_window_shared_tile": (_P,) * 4 + (_I,) * 7 + (_P,),
    "magent_threefry": (_P, _L, _L, _L, _I, _U, _U, _U, _I, _F, _F, _I, _I,
                        _P),
    "magent_gru_cell": (_I, _I, _L, _I) + (_P,) * 12 + (_I,),
    "magent_gru_cell_backward": (_I, _I, _L, _I) + (_P,) * 18 + (_I,),
}

_lib = None
_lock = threading.Lock()

# kernel launches by kernel name (the C launcher's name without "magent_");
# only launches of a CUDA kernel count, never plain-version calls
LAUNCHES: collections.Counter = collections.Counter()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _stamp() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> str:
    """Compile and link the kernels library unless it is current.  Returns
    the compiler's output (``-Xptxas -v`` register and shared-memory use),
    empty when the build was skipped.  Holds the cross-process build lock
    throughout."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        return _build_locked(force)


def _build_locked(force: bool) -> str:
    stamp_path = BUILD_DIR / "stamp"
    stamp = _stamp()
    if (not force and LIB_PATH.exists() and stamp_path.exists()
            and stamp_path.read_text() == stamp):
        return ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, name + ".o") for name in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)
        ]
        failed = []
        for name, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            log.append("== nvcc %s\n%s" % (name, out))
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed on %s:\n%s" % (failed, "\n".join(log)))
        tmp_lib = os.path.join(tmp, LIB_PATH.name)
        link = subprocess.run([nvcc, "-shared", "-o", tmp_lib, *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        log.append("== link\n%s" % link.stdout)
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n%s" % "\n".join(log))
        os.replace(tmp_lib, LIB_PATH)
    stamp_path.write_text(stamp)
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    return "\n".join(log)


def lib() -> ctypes.CDLL:
    """The loaded kernels library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes + (_I, _P)
                fn.restype = ctypes.c_int
            handle.magent_cuda_error_string.argtypes = (ctypes.c_int,)
            handle.magent_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C launcher ``name`` on ``device`` and its current stream
    (the library sets its own current device: it carries its own CUDA
    runtime); raise if the launch was refused, else count the launch."""
    handle = lib()
    index = device_index(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(handle, name)(*args, index, stream)
    if rc != 0:
        msg = handle.magent_cuda_error_string(rc).decode()
        raise RuntimeError("%s: CUDA error %d (%s)" % (name, rc, msg))
    LAUNCHES[name.removeprefix("magent_")] += 1


def device_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of CUDA ``device`` (the kernels' launch splits depend
    on it)."""
    return _sm_count(device_index(device))


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Validate a kernel operand: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise ValueError("%s has dtype %s, expected %s" % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def route(*tensors) -> str:
    """``"cpu"`` for the plain version, ``"cuda"`` for the kernel; any other
    device (or a mix) raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return "cpu"
    if types == {"cuda"}:
        return "cuda"
    raise ValueError("kernel operands must all lie on the CPU or all on one "
                     "CUDA device, got %s" % sorted(types))
