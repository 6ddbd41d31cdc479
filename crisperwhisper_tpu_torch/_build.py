"""Build the port's CUDA kernels at first use and bind them with ctypes.

The sources in ``csrc/`` have a plain C interface. ``kernels()`` compiles
them with ``nvcc`` for Hopper (``sm_90a``), one process per source, all in
parallel, links them into one shared library, loads
it and declares every entry's argument types: each pointer and the stream
are ``c_void_p`` (a bare Python int would be cut to 32 bits), each size a
``c_int``. The library lands in ``_build/`` beside this file (git-ignored)
under a name that hashes the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

No ``--use_fast_math``: the DTW kernel must match its plain version
exactly, and its tie-breaks depend on IEEE adds and compares; the
attention kernel's f32 route and the decode-step kernel use the precise
``expf``, ``erff`` and division. The attention kernel's 16-bit route
issues ``ex2.approx.ftz.f32`` by name, on purpose: it comes within a few
f32 ulps of 2^x, far below the one 16-bit epsilon that P loses when
it is rounded to bf16 or f16 for the second product, and it flushes only
probabilities below 2^-126 of the row's largest to zero. The log-mel
kernel's DFT feeds ``log10f``, where approximate arithmetic would show
in the quiet bins. ``compile_object`` compiles one
source alone (the probe ladder runs it a source at a time).

Each C entry returns its launch's error code (``cudaGetLastError()``, or
the ``CUresult`` of ``cuLaunchKernel`` for the kernels launched
through ``csrc/launch.cuh``); ``check`` raises on anything but 0, because a
refused launch never runs and a later ``torch.cuda.synchronize()`` would
not report it.

``launcher`` is the lean path from a wrapper to its C entry (the
alignment prep, the DTW, the ring writes, the log-mel, the decode
attention, the grouped expert kernel and the probe): the raw handle
of PyTorch's current stream (``current_stream``, no Python Stream
object), a device guard only when the tensors' device is not the current
one, one ctypes call, and ``check``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("encoder_attention.cu", "align_prep.cu", "dtw.cu",
           "decode_step.cu", "ring_write.cu", "log_mel.cu",
           "decode_attention.cu", "moe.cu", "probe.cu")
HEADERS = ("launch.cuh",)       # included by sources; part of the digest
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")


@dataclass(frozen=True)
class Kernels:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float        # 0.0 when an up-to-date library was found
    ptxas_log: str              # nvcc's -Xptxas=-v report of this build


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def compile_object(source: Path, obj: Path, *flags: str) -> str:
    """Compile one CUDA source to an object file with ``nvcc`` (``flags``
    after the usual ones, e.g. a test build's ``-D``) and return its log
    (ptxas registers and spills). Raises a RuntimeError that names the
    source when nvcc refuses it."""
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-c", "-o",
                           str(obj), str(source)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} (exit code "
                           f"{proc.returncode}):\n{proc.stdout}")
    return proc.stdout


def link(objs: list[Path], out: Path) -> None:
    """Link object files into the shared library ``out`` with ``nvcc``."""
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                           str(out), *map(str, objs)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to link (exit code "
                           f"{proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")


def _build() -> tuple[Path, float, str]:
    """Compile every source to an object with one ``nvcc`` each, all
    started together (the first build is on the smoke's clock), then link
    them into one shared library."""
    so = BUILD_DIR / f"libcw_kernels_{_digest()}.so"
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(n).stem}.o" for n in SOURCES]
    tmp = so.with_name(f"{tag}.so.tmp")
    t0 = time.perf_counter()
    try:
        # each thread waits on its own nvcc process, so they run together
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            logs = list(pool.map(compile_object,
                                 [CSRC / n for n in SOURCES], objs))
        link(objs, tmp)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, so)            # atomic: a concurrent loader sees all or
    return so, time.perf_counter() - t0, "".join(logs)  # nothing


# held around the first build and the first lookup of each launcher: a
# live session in the caller's thread and a batcher's worker thread can
# make their first launch at once, and must not run nvcc twice
_FIRST_USE = threading.RLock()


@functools.lru_cache(maxsize=None)
def kernels() -> Kernels:
    """Build (if needed) and load the CUDA kernel library, once per process
    and whatever the number of threads that ask first."""
    with _FIRST_USE:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> Kernels:
    path, seconds, log = _build()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for entry in (lib.cw_encoder_attention, lib.cw_encoder_attention_tc):
        entry.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        entry.restype = i32
    lib.cw_encoder_attention_tc_smem.argtypes = [i32]
    lib.cw_encoder_attention_tc_smem.restype = i32
    lib.cw_align_prep.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.cw_align_prep.restype = i32
    lib.cw_dtw.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.cw_dtw.restype = i32
    lib.cw_decode_step.argtypes = [ptr] * 14 + [i32] * 14 + [
        ctypes.c_float, ptr, ptr]
    lib.cw_decode_step.restype = i32
    lib.cw_ring_write.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
    lib.cw_ring_write.restype = i32
    lib.cw_log_mel.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    lib.cw_log_mel.restype = i32
    for entry in (lib.cw_cross_attention_int8,
                  lib.cw_cross_attention_int8_v2):
        entry.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
        entry.restype = i32
    lib.cw_decode_gemv_attention.argtypes = [ptr] * 10 + [i32] * 12 + [ptr]
    lib.cw_decode_gemv_attention.restype = i32
    for entry in (lib.cw_moe_gate_up, lib.cw_moe_down):
        entry.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        entry.restype = i32
    lib.cw_probe_add.argtypes = [ptr, ptr, i32, ptr]
    lib.cw_probe_add.restype = i32
    lib.cw_error_string.argtypes = [i32]
    lib.cw_error_string.restype = ctypes.c_char_p
    return Kernels(lib=lib, path=path, build_seconds=seconds, ptxas_log=log)


def check(err: int, name: str) -> None:
    """Raise when a C entry reports a CUDA error for its launch."""
    if err != 0:
        msg = kernels().lib.cw_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({err}: {msg})")


@functools.cache
def _cuda_api():
    """(current device index, raw handle of a device's current stream):
    PyTorch's own getters, private (a card test pins them to the public
    ones) and present only in a CUDA build, so looked up at the first
    launch."""
    return torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream


def current_stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on CUDA device ``index``:
    ``torch.cuda.current_stream(index).cuda_stream`` without building a
    Stream object (under ``torch.cuda.stream`` and during graph capture
    alike)."""
    return _cuda_api()[1](index)


@functools.cache
def launcher(entry: str):
    """``launch(index, *args)``: the library's C entry ``entry`` called as
    ``entry(*args, stream)`` on PyTorch's current stream of CUDA device
    ``index``, under a device guard only when that device is not the
    current one; raises on a launch error, naming the entry without its
    ``cw_`` prefix. Built once per entry, so a call looks nothing up."""
    with _FIRST_USE:
        fn = getattr(kernels().lib, entry)
    name = entry.removeprefix("cw_")
    device, stream = _cuda_api()

    def launch(index: int, *args) -> None:
        if device() == index:
            err = fn(*args, stream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, stream(index))
        if err:
            check(err, name)
    return launch
