"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``rtts_torch/csrc/*.cu`` file is compiled for ``sm_90a`` (one nvcc
process per source, all started together) and the objects are linked into
one shared library with a plain C interface, under ``build/rtts_torch/`` at
the root of the checkout.  The library's name carries a hash of the sources
and headers, so an edited kernel is rebuilt at its first use and an
unchanged one is loaded as it is.
Nothing here runs at import: the first kernel launch calls ``library()``.
A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "rtts_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# the flash kernels' trailing arguments: dtype, bh, heads, lq, lk, dh,
# sm_scale, causal, self_mask, q_offset, seed, drop_thr, drop_scale, the
# dropout hash's batch offset, head offset and total heads, stream
_FLASH_SCALARS = [_I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _U, _I, _F,
                  _I, _I, _I, _P]
# the LSH attend kernels' trailing arguments: dtype, n, nc, c, dh, causal,
# before, after, mask_value, self_mask_value, stream
_LSH_SCALARS = [_I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
# C signatures of the entry points (each returns a cudaError_t as int)
SIGNATURES = {
    "rtts_flash_fwd": [_P] * 6 + _FLASH_SCALARS,
    # q, k, v, o, dout, lse, kv_mask, dk, dv, Di scratch, f32 partials;
    # number of query splits; the flash scalars
    "rtts_flash_bwd_dkv": [_P] * 11 + [_I] + _FLASH_SCALARS,
    "rtts_flash_bwd_dq": [_P] * 8 + _FLASH_SCALARS,
    # dims (7 ints: x dtype, w/b dtype, batch, len, channels, taps, vector
    # width), x, w, b, out, stream
    "rtts_depthwise_conv1d": [_P] * 6,
    # q, k, v, pos, valid, out, lse; the route (1 tensor cores, 0 f32
    # FMA); the LSH scalars
    "rtts_lsh_attend_fwd": [_P] * 7 + [_I] + _LSH_SCALARS,
    # q, k, v, pos, valid, dout, dlse, dq, dk, dv, the f32 row stats; the
    # route (1 tensor cores, 0 f32 FMA); the LSH scalars
    "rtts_lsh_attend_bwd": [_P] * 11 + [_I] + _LSH_SCALARS,
    # x, ln scale and bias, W_in, b_in, W_out, b_out, out, the bf16 weight
    # scratch; dtype, n, d, f, the scratch's padded d and f, activation,
    # the route (rows a block on tensor cores, 0 f32 FMA), eps, stream
    "rtts_ffn_fused": [_P] * 9 + [_I] * 8 + [_F, _P],
    # x, out; n, cols, columns per block, stream
    "rtts_bitonic_sort_cols": [_P, _P, _I, _I, _I, _P],
    # buckets, sorted_pos, undo_idx, sorted_buckets; rows, L, CTAs a row,
    # rows a block, stream
    "rtts_sort_by_bucket": [_P] * 4 + [_I] * 4 + [_P],
    # x, idx, out; m, rows, row bytes, vector bytes, stream
    "rtts_row_gather": [_P, _P, _P, _I, _I, _I, _I, _P],
    # what the runtime reports of the bf16 kernels (``resources``): dh
    # (K4, K5: dh, chunk length, window chunks; K6: rows a block, width),
    # out
    "rtts_flash_fwd_resources": [_I, _P],
    "rtts_lsh_attend_fwd_resources": [_I, _I, _I, _P],
    "rtts_lsh_attend_bwd_resources": [_I, _I, _I, _P],
    "rtts_ffn_fused_resources": [_I, _I, _P],
}

_lib = None
_functions = {}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the "
                       "rtts_torch CUDA kernels cannot be built")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librtts_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless a library built from them exists.  nvcc's
    output (registers and shared memory per kernel) is kept beside it, in
    ``build_log_path()``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # objects and the library go to a private directory and the library is
    # renamed into place: a concurrent loader never sees a half-written one
    work = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = [(src, work / f"{src.stem}.o") for src in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in jobs]
        log, failed = "", []
        for (src, _), proc in zip(jobs, procs):
            log += f"== {src.name}\n{proc.communicate()[0]}"
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = work / out.name
        link = subprocess.run([nvcc, "-shared", "-o", str(lib),
                               *(str(obj) for _, obj in jobs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        build_log_path().write_text(log)
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def build_log_path() -> pathlib.Path:
    return library_path().with_suffix(".log")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def function(name: str):
    """The entry point ``name`` of the loaded library, resolved once."""
    fn = _functions.get(name)
    if fn is None:
        fn = _functions[name] = getattr(library(), name)
    return fn


def stream(index: int) -> int:
    """The handle of the current CUDA stream of the card with this index
    (``Tensor.get_device()``), read without building a
    ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


def resources(name: str, *args: int, kernels: int = 1) -> list:
    """What the runtime reports of the ``kernels`` kernels behind the entry
    point ``name`` (``rtts_*_resources``) on this card: for each, registers
    and spill bytes a thread, dynamic shared bytes a block, blocks an SM."""
    out = (ctypes.c_int * (4 * kernels))()
    check(function(name)(*args, out), name)
    keys = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")
    return [dict(zip(keys, out[4 * i:4 * i + 4])) for i in range(kernels)]


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
