"""Build and load the port's native libraries: the CUDA kernels
(``csrc/*.cu``) and the host data plane (``native/data_plane.cpp``).

Counterpart of the JAX package's ctypes module for its C++ data plane.
Each CUDA source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/`` beside
this package's sources (listed in ``.gitignore``), named by a hash of
the source, the ``csrc`` headers it includes and the flags, so an edited
kernel or header is rebuilt. Libraries load through ``ctypes``; the
wrappers pass pointers (``data_ptr()``) and the stream
(``torch.cuda.current_stream().cuda_stream``) as ``c_void_p``.

The host library (quantile binning, ``bin_matrix``) is built the same
way by the host C++ compiler (``$CXX``, else ``c++`` or ``g++``) with
``HOST_FLAGS`` — no ``-march=native``, since the name does not hash the
CPU — on every machine the port runs on, the CPU tests' included. It
loads with ``ctypes.CDLL``, so a call releases the interpreter lock and
request threads bin in parallel. A failed build raises; nothing falls
back to numpy.

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
import threading
from pathlib import Path
from typing import Dict, Iterable, List

import numpy as np

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
        # offsets, order, int32 ids' scratch, acc, out, n, f, b, width,
        # f_slice, num_slices, bin bytes (1 uint8, 2 uint16, 4 int32 ids),
        # tile bins, tiles, smem bytes, device, stream
        "mmls_level_hist": ([_VP] * 5 + [_I] + [_VP] * 7 + [_LL]
                            + [_I] * 10 + [_VP], _I),
        # bin bytes, smem bytes, slices, tiles, device, out: 4 int32 (SMs,
        # CTAs per SM, CTAs, CTAs per tile)
        "mmls_level_hist_grid": ([_I] * 5 + [ctypes.POINTER(_I)], _I),
        # grad, hess, live, amax bits (3 uint64), n, device, stream
        "mmls_level_hist_amax": ([_VP] * 4 + [_LL, _I, _VP], _I),
        # binned, grad, hess, live, local, local bytes, stats, counts,
        # offsets, order, int32 ids' scratch, exps (3 int64), acc, n, f,
        # b, width, f_slice, num_slices, bin bytes, tile bins, tiles, smem
        # bytes, device, stream
        "mmls_level_hist_sums": ([_VP] * 5 + [_I] + [_VP] * 7 + [_LL]
                                 + [_I] * 10 + [_VP], _I),
        # acc, exps, out, cells, device, stream
        "mmls_level_hist_round": ([_VP] * 3 + [_LL, _I, _VP], _I),
        "mmls_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "level_hist_quant": {
        # binned, grad_q, hess_q, live, local, local bytes, stats, counts,
        # offsets, order, int32 ids' scratch, acc, out, gscale_inv,
        # hscale_inv, qbits, n, f, b, width, f_slice, num_slices, bin bytes
        # (1, 2, 4 as above), tile bins, tiles, smem bytes, window, device,
        # stream
        "mmls_level_hist_quant": ([_VP] * 5 + [_I] + [_VP] * 9 + [_I, _LL]
                                  + [_I] * 11 + [_VP], _I),
        # acc, out, gscale_inv, hscale_inv, cells, device, stream
        "mmls_level_hist_quant_dequantize": ([_VP] * 4 + [_LL, _I, _VP],
                                             _I),
        # as mmls_level_hist_grid
        "mmls_level_hist_quant_grid": ([_I] * 5 + [ctypes.POINTER(_I)], _I),
        "mmls_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attn": {
        # q, k, v, out, dtype, b, h, n, nk, d, (b, n, h) strides of q, k,
        # v and out, scale, causal, device, stream
        "mmls_flash_attn": ([_VP] * 4 + [_I] * 6 + [_LL] * 12
                            + [ctypes.c_float, _I, _I, _VP], _I),
        "mmls_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "tree_score": {
        # x, x code (1, 2, 4: uint8, uint16, int32 ids against 32-bit bin
        # nodes; 9, 10, 12 the same against wide bin nodes; 5 raw float32
        # rows), packed nodes, products, out, init_score, n, f, trees,
        # nodes per tree, depth, classes, the plan (regime, rows, CTAs,
        # cluster, chunk, smem bytes, shared), device, stream
        "mmls_tree_score": ([_VP, _I] + [_VP] * 3 + [ctypes.c_float, _LL]
                            + [_I] * 13 + [_VP], _I),
        # host x, x, x code, x bytes, packed nodes, products, out, host
        # out, init_score, n, f, trees, nodes per tree, depth, classes, the
        # plan, device, stream
        # x, packed decision nodes, products, out, init_score, n, f,
        # trees, nodes per tree, depth, classes, bitsets, words per
        # bitset, leaf map, leaf slots (or null), the plan, device, stream
        "mmls_tree_score_decision": ([_VP] * 4 + [ctypes.c_float, _LL]
                                     + [_I] * 5 + [_VP, _I, _VP, _VP]
                                     + [_I] * 8 + [_VP], _I),
        "mmls_tree_score_staged": ([_VP, _VP, _I, _LL] + [_VP] * 4
                                   + [ctypes.c_float, _LL] + [_I] * 13
                                   + [_VP], _I),
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

# Libraries whose calls keep the interpreter lock (ctypes.PyDLL): a
# scoring call launches a kernel or moves one served batch in tens of
# microseconds, and a thread that gives the lock up waits up to a switch
# interval (5 ms) to take it back while request threads are busy.
HOLD_GIL = ("tree_score",)

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
    lib = (ctypes.PyDLL if name in HOLD_GIL else ctypes.CDLL)(
        str(library_path(name)))
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


# --- the host data plane -----------------------------------------------------

NATIVE = Path(__file__).resolve().parent
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
HOST_SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "data_plane": {
        # vals, val bytes, n, f, uppers, n_bins, out, out bytes
        "mmls_bin_matrix": ([_VP, _I, _LL, _LL, _VP, _I, _VP, _I], _I),
    },
}
_host_lock = threading.Lock()
_host_libs: Dict[str, ctypes.CDLL] = {}


def host_compiler() -> str:
    return (os.environ.get("CXX") or shutil.which("c++")
            or shutil.which("g++") or "g++")


def host_library_path(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """``build_dir/lib{name}-host-{hash}.so``, the hash of
    ``native/{name}.cpp`` and ``HOST_FLAGS``."""
    digest = hashlib.sha256((NATIVE / f"{name}.cpp").read_bytes())
    digest.update(" ".join(HOST_FLAGS).encode())
    return build_dir / f"lib{name}-host-{digest.hexdigest()[:16]}.so"


def build_host(name: str, compiler: str = "",
               build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``native/{name}.cpp`` with ``compiler`` (default
    ``host_compiler()``) unless it is built; returns the library's path.
    Raises ``RuntimeError`` naming the source if the build fails."""
    target = host_library_path(name, build_dir)
    if target.exists():
        return target
    build_dir.mkdir(parents=True, exist_ok=True)
    source = NATIVE / f"{name}.cpp"
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler or host_compiler(), *HOST_FLAGS, "-o", str(tmp),
           str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host library build failed: {source} "
                           f"({cmd[0]}: {e})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"host library build failed: {source} ({cmd[0]} "
                           f"exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, target)  # atomic: a reader never sees half a file
    return target


def load_host(name: str) -> ctypes.CDLL:
    """The host library ``name`` (built first if needed), with every
    function's argument and result types declared."""
    with _host_lock:
        lib = _host_libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(name)))
            for fn_name, (argtypes, restype) in \
                    HOST_SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _host_libs[name] = lib
        return lib


_BIN_VALUES = (np.dtype(np.float32), np.dtype(np.float64))
# bin-id dtypes and the largest id each holds
_BIN_IDS = {np.dtype(t): np.iinfo(t).max for t in (np.uint8, np.uint16,
                                                   np.int32)}


def bin_matrix(vals: np.ndarray, uppers: np.ndarray, out: np.ndarray) -> None:
    """Bin the C-contiguous (n, f) float32/float64 ``vals`` by the
    C-contiguous (f, n_bins) float64 inf-padded upper edges into ``out``
    ((n, f) uint8, uint16 or int32, C-contiguous): NaN -> 0, else 1 + the
    first edge index whose edge is >= the value
    (``native/data_plane.cpp``)."""
    n, f = vals.shape
    n_bins = uppers.shape[1] if uppers.ndim == 2 else 0
    if vals.dtype not in _BIN_VALUES or uppers.dtype != np.float64 \
            or out.dtype not in _BIN_IDS:
        raise ValueError(f"bin_matrix takes float32/float64 values, float64 "
                         f"edges and uint8/uint16/int32 bin ids, got "
                         f"{vals.dtype}, {uppers.dtype}, {out.dtype}")
    if uppers.shape != (f, n_bins) or n_bins < 1 or out.shape != (n, f):
        raise ValueError(f"bin_matrix: values {vals.shape}, edges "
                         f"{uppers.shape}, out {out.shape}")
    if not all(a.flags.c_contiguous for a in (vals, uppers, out)):
        raise ValueError("bin_matrix takes C-contiguous arrays")
    if n_bins > _BIN_IDS[out.dtype]:
        raise ValueError(f"bin ids up to {n_bins} do not fit {out.dtype}")
    code = load_host("data_plane").mmls_bin_matrix(
        vals.ctypes.data, vals.itemsize, n, f, uppers.ctypes.data, n_bins,
        out.ctypes.data, out.itemsize)
    if code != 0:
        raise RuntimeError(f"mmls_bin_matrix returned {code}")
