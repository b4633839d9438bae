"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Counterpart of the JAX package's ctypes module for its C++ data plane.
Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/`` beside this
package's sources (listed in ``.gitignore``), named by a hash of the
source, the ``csrc`` headers it includes and the flags, so an edited
kernel or header is rebuilt. Libraries load through ``ctypes``; the
wrappers pass pointers (``data_ptr()``) and the stream
(``torch.cuda.current_stream().cuda_stream``) as ``c_void_p``.

Nothing here runs at import: the CPU tests import this module on
machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C signatures of every kernel library: name -> {function: (argtypes, restype)}
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "level_hist": {
        # binned, grad, hess, live, local, local bytes, stats, counts,
        # offsets, order, acc, out, n, f, b, width, f_slice, num_slices,
        # smem bytes, device, stream
        "mmls_level_hist": ([_VP] * 5 + [_I] + [_VP] * 6 + [_LL]
                            + [_I] * 7 + [_VP], _I),
        "mmls_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "level_hist_quant": {
        # binned, grad_q, hess_q, order, offsets, tile_end, acc, out,
        # gscale_inv, hscale_inv, qbits, f, b, width, tile_rows,
        # num_tiles, f_slice, num_slices, device, stream
        "mmls_level_hist_quant": ([_VP] * 10 + [_I] * 9 + [_VP], _I),
        "mmls_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attn": {
        # q, k, v, out, dtype, b, h, n, nk, d, (b, n, h) strides of q, k,
        # v and out, scale, causal, device, stream
        "mmls_flash_attn": ([_VP] * 4 + [_I] * 6 + [_LL] * 12
                            + [ctypes.c_float, _I, _I, _VP], _I),
        "mmls_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attn_sm90": {
        # q, k, v, out, TMA geometry (12 int64 per q, k, v), b, h, n, nk,
        # d, (b, n, h) strides of out, scale, causal, device, stream
        "mmls_flash_attn_sm90": ([_VP] * 4 + [ctypes.POINTER(_LL)]
                                 + [_I] * 5 + [_LL] * 3
                                 + [ctypes.c_float, _I, _I, _VP], _I),
        "mmls_cuda_error_string": ([_I], ctypes.c_char_p),
    },
}

_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def sources(name: str) -> List[Path]:
    """``csrc/{name}.cu`` and every ``csrc`` header it includes with
    quotes, directly or through another header."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep not in found:
                found.append(dep)
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` per source, all started together. Returns ``{name: ptxas
    report}`` for the sources it compiled (registers, shared memory,
    spills). Raises ``RuntimeError`` naming the source if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs: List[tuple] = []
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports: Dict[str, str] = {}
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a reader never sees half a file
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` (built first if needed), with the
    argument and result types of every function declared."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.mmls_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
