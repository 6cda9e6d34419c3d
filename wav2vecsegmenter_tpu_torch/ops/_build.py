"""Build and load the CUDA kernels of ``ops/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` (one process per file, in parallel)
and links them into one shared library with a plain C interface, loaded
with ``ctypes`` (pointers and the stream as ``c_void_p``).
That builds in seconds, where an extension that includes PyTorch's headers
takes minutes.  The library lands in ``wav2vecsegmenter_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so a
checkout builds once and later processes load the cached file.

Nothing is built at import: the first kernel launch calls :func:`library`.
A failed build or load raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the exported entry points (ctypes would otherwise pass a
# pointer as a 32-bit int and cut it)
_SIGNATURES = {
    # x, conv_bias, scale, bias, out, rows, h, eps, dtype, gelu, stream
    "w2v_layer_norm": (_P, _P, _P, _P, _P, _L, _I, _F, _I, _I, _P),
    # q, k, v, key_mask, out, stats, b, tq, tk, heads, d,
    # q/k/v/out strides (batch, time, head), scale, dtype, stream
    "w2v_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                      _F, _I, _P),
    # x, w1, b1, w2, b2, hidden, out, rows, h, f, dtype, stream
    "w2v_ffn": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
    # x, w, conv_bias, scale, bias, out, batch, t_in, c_in, k, stride,
    # t_out, n_out, eps, dtype, stream
    "w2v_conv_ln_gelu": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _L,
                         _I, _F, _I, _P),
    "w2v_conv_audio_ln_gelu": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I,
                               _L, _I, _F, _I, _P),
    # x, scale, g, dx (or None), dscale, dbias, partial, rows, h, n_part,
    # eps, dtype, stream
    "w2v_layer_norm_bwd": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _L, _F, _I,
                           _P),
    # rows, h, dtype, dx -> n_part, the partial rows the call above needs
    "w2v_layer_norm_bwd_partials": (_L, _I, _I, _I),
    # q, k, v, key_mask, do, dq, dk, dv, o, stats, rows, strides (host
    # array of 24), b, tq, tk, heads, d, scale, dtype, stream
    "w2v_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _F, _I, _P),
}

_lib = None
build_seconds: float | None = None  # wall time of the nvcc run, None if cached
build_log: str = ""  # nvcc's output (ptxas register report), kept beside
                     # the library and read back when it is cached


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"w2vseg_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one nvcc process per ``.cu`` file, all started together, then a link."""
    global build_seconds, build_log
    out = library_path()
    log = out.with_suffix(".log")
    if out.is_file():
        build_log = log.read_text() if log.is_file() else ""
        return out
    nvcc = _nvcc()
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        objs, procs = [], []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = work / f"{src.stem}.o"
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{build_log}")
        tmp = work / out.name
        proc = subprocess.run([nvcc, *NVCC_ARCH, "-shared", "-o", str(tmp),
                               *objs], capture_output=True, text=True,
                              check=False)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{build_log}")
        log.write_text(build_log)
        os.replace(tmp, out)
    finally:
        build_seconds = time.perf_counter() - t0
        shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.w2v_error_string.argtypes = (ctypes.c_int,)
        lib.w2v_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        msg = library().w2v_error_string(status).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({status})")


def dtype_code(dtype) -> int:
    """The kernels' element-type code: 0 = float32, 1 = bfloat16."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
