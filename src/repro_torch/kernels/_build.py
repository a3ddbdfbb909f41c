"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface and loaded with
``ctypes``.  The build runs at first use, into ``_build/`` next to this
package (``REPRO_TORCH_BUILD_DIR`` overrides it); a library's file name
carries a hash of its source and flags, so an edited source rebuilds.
``build_all`` compiles every source at once, one ``nvcc`` process each.
A build may add ``-D`` flags (``defines``): the library then gets a name
of its own, so ``tools/check_hopper_kernels.py`` can load a probing build
of a kernel beside the one every path uses.

Every launch goes through ``kernel`` (a C function's typed prototype,
made once) and ``launch`` (the stream, the error check, the count).  The
counts are kept per library, under the names in ``SOURCES``
(``launch_counts``).  Adding a kernel touches its source, its wrapper and
``SOURCES``.

Nothing here runs at import time: the package imports on a host with no
``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, NamedTuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("partition_hist_fused", "radix_scatter", "seg_agg", "hash_bucket",
           "radix_hist", "partitioned_probe", "flash_attn", "ssd_intra_chunk",
           "csr_probe", "sha1_tree")

# The C types of the kernels' arguments: pointers and the stream, 64- and
# 32-bit ints.
PTR, I64, I32, U32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_uint)

_lock = threading.Lock()
_libs: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
_count_lock = threading.Lock()
_counts = dict.fromkeys(SOURCES, 0)
_variants: dict[str, dict[str, int]] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS + tuple(defines))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def _start(name: str, defines: tuple[str, ...] = ()):
    """Start ``nvcc`` for one source; None when the library is built."""
    out = _lib_path(name, defines)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a reader sees a whole library or none


def build_all(names=SOURCES, defines: tuple[str, ...] = ()) -> None:
    """Compile every named source in parallel (one nvcc each)."""
    with _lock:
        started = {n: _start(n, defines) for n in names}
        errors = []
        for n, s in started.items():
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    key = (name, tuple(defines))
    lib = _libs.get(key)
    if lib is None:
        build_all((name,), key[1])
        with _lock:
            lib = _libs.get(key)
            if lib is None:
                lib = _libs[key] = ctypes.CDLL(str(_lib_path(*key)))
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


class Kernel(NamedTuple):
    lib: str        # csrc/<lib>.cu, the library its launches count under
    name: str       # the C function
    fn: Callable    # its typed prototype


@functools.cache
def kernel(lib: str, name: str, *argtypes, returns=I32,
           defines: tuple[str, ...] = ()) -> Kernel:
    """The C function ``name`` of ``csrc/<lib>.cu`` (built with
    ``defines``), typed once.  Its calls hold the interpreter lock
    (``ctypes.PYFUNCTYPE``): a launch takes microseconds, and giving the
    lock up for it lets a busy thread keep it for a whole switch interval
    (5 ms) before this one gets it back."""
    proto = ctypes.PYFUNCTYPE(returns, *argtypes)
    return Kernel(lib, name, proto((name, load(lib, defines))))


def launch(k: Kernel, dev: torch.device, *args,
           variant: str | None = None) -> None:
    """Call ``k`` with ``args`` and the current stream of ``dev``, raise
    on a non-zero ``cudaError_t``, and count one launch of ``k.lib`` (and
    of ``variant``, for a library with ``variant_counts``)."""
    if dev.index in (None, torch.cuda.current_device()):
        err = k.fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = k.fn(*args, torch.cuda.current_stream().cuda_stream)
    check(err, k.name if variant is None else f"{k.name} ({variant})")
    with _count_lock:
        _counts[k.lib] += 1
        if variant is not None:
            _variants[k.lib][variant] += 1


def variant_counts(lib: str, variants) -> dict[str, int]:
    """The launches of each of ``lib``'s ``variants``, kept up to date by
    ``launch`` and zeroed by ``reset_launch_counts``."""
    return _variants.setdefault(lib, dict.fromkeys(variants, 0))


def launch_counts() -> dict[str, int]:
    """Kernel launches per library since the last reset."""
    return dict(_counts)


def reset_launch_counts() -> None:
    """Zero every library's count and every variant count."""
    with _count_lock:
        for counts in (_counts, *_variants.values()):
            counts.update(dict.fromkeys(counts, 0))
