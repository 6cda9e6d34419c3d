"""ctypes binding for the repo's native audio code
(``native/audio/{wav_loader,flac_writer}.cpp``): wav info, window reads and
FLAC encoding.

The port's counterpart of ``wav2vecsegmenter_tpu/data/native_audio.py``.
That module runs ``make`` inside ``native/audio``, which writes its library
next to the sources; the port never writes there.  :func:`build_native`
compiles the sources with ``g++`` into ``wav2vecsegmenter_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags, as
``ops/_build.py`` does for the CUDA kernels; ``stpipe/mwer.py`` builds the
mWER resegmenter the same way.  Each build writes a file of its own and
renames it into place, so processes that race the first build each end with
a whole file.  The library is built on first use.  Without a compiler (or
when the build fails) :func:`available` is False and ``stpipe/flac.py``
falls back to its bit-identical Python encoder, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/audio/Makefile's flags, as a shared library
AUDIO_SOURCES = ("audio/wav_loader.cpp", "audio/flac_writer.cpp")
AUDIO_FLAGS = ("-O3", "-std=c++17", "-Wall", "-fPIC", "-shared")

_LIB = None
_TRIED = False
_INIT_LOCK = threading.Lock()


def build_native(name: str, sources: tuple, flags: tuple,
                 suffix: str = "") -> Path:
    """``g++ flags sources -o _build/<name>_<hash><suffix>`` unless that file
    exists; ``sources`` are paths under ``native/``.  Raises when there is
    no compiler or the build fails."""
    paths = [NATIVE_DIR / s for s in sources]
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"{name}_{h.hexdigest()[:16]}{suffix}"
    if out.is_file():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler found (g++, or set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    try:
        proc = subprocess.run([cxx, *flags, "-o", str(tmp),
                               *map(str, paths)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) building "
                               f"{name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load():
    global _LIB, _TRIED
    # reader threads race the first call: without the lock a second thread
    # could see _TRIED mid-build and report "no native library"
    with _INIT_LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        return _load_locked()


def _load_locked():
    global _LIB
    try:
        so = build_native("libw2vaudio", AUDIO_SOURCES, AUDIO_FLAGS, ".so")
        lib = ctypes.CDLL(str(so))
        lib.w2v_wav_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.w2v_wav_info.restype = ctypes.c_int
        lib.w2v_read_window.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.w2v_read_window.restype = ctypes.c_long
        lib.w2v_flac_bound.argtypes = [ctypes.c_long]
        lib.w2v_flac_bound.restype = ctypes.c_long
        lib.w2v_encode_flac.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ]
        lib.w2v_encode_flac.restype = ctypes.c_long
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def wav_info(path: str) -> tuple[int, int, int]:
    lib = _load()
    n = ctypes.c_long()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    rc = lib.w2v_wav_info(str(path).encode(), ctypes.byref(n),
                          ctypes.byref(sr), ctypes.byref(ch))
    if rc != 0:
        raise OSError(f"w2v_wav_info failed ({rc}) for {path}")
    return int(n.value), int(sr.value), int(ch.value)


def read_window(path: str, offset: int, num_frames: int) -> np.ndarray:
    lib = _load()
    if num_frames < 0:
        total, _, _ = wav_info(path)
        num_frames = total - offset
    out = np.empty(max(0, num_frames), np.float32)
    if num_frames == 0:
        return out
    got = lib.w2v_read_window(
        str(path).encode(), int(offset), int(num_frames),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if got < 0:
        raise OSError(f"w2v_read_window failed ({got}) for {path}")
    return out[: int(got)]


def encode_flac(samples_i16: np.ndarray, sample_rate: int) -> bytes:
    lib = _load()
    samples_i16 = np.ascontiguousarray(samples_i16, dtype=np.int16)
    n = len(samples_i16)
    cap = int(lib.w2v_flac_bound(n))
    out = np.empty(cap, np.uint8)
    got = lib.w2v_encode_flac(
        samples_i16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n,
        int(sample_rate), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if got < 0:
        raise OSError(f"w2v_encode_flac failed ({got})")
    return out[: int(got)].tobytes()
