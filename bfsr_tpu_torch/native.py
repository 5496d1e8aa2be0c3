"""The host-side resampling library: the counterpart of ``bfsr_tpu/native.py``.

``csrc/host/bfsr_native.cc`` holds three C entries on float32 HWC arrays,
each parallel over its output with OpenMP: ``bilinear_resize`` (the
``F.interpolate(mode='bilinear')`` semantics of
``data/np_interp.resize_bilinear_np``), ``updownup_residual`` (the data
wrappers' LR-up and its up-down-up residual in one call; ``data/wrappers``
computes every residual with it) and ``bicubic_resize`` (MATLAB
``imresize``, as the float64 ``ops/imresize.imresize`` computes it).

At first use ``library()`` compiles the source with ``g++ -O3
-march=native -fopenmp -fPIC -shared`` (``g++`` on the PATH) into
``bfsr_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source, the flags, ``g++ --version`` and the target options
``-march=native`` resolves to on this host (``g++ -march=native -Q
--help=target``: such code runs only on a CPU with the instructions it was
built for), written under a temporary name and renamed into place, so that
processes building at once do not race; then loads it with ``ctypes``,
which releases the GIL for each call.  Nothing runs at import time.  There
is no fallback: if the build or the load fails, ``library()`` raises with
the compiler's message.  The numpy versions (``resize_bilinear_np``,
``data/wrappers.residuals_np``, ``imresize``) are the plain twins the tests
hold these against.  Each call runs on OpenMP's default team; each output
element is computed by one thread alone.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "bfsr_native.cc"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-fPIC", "-shared", "-Wall"]

_F32P = ctypes.POINTER(ctypes.c_float)
_I = ctypes.c_int
# C entry name -> argtypes
_SIGNATURES = {
    "bilinear_resize_f32": [_F32P, _I, _I, _I, _F32P, _I, _I, _I],
    "updownup_residual_f32": [_F32P, _I, _I, _I, _I, _I, _F32P, _F32P],
    "bicubic_resize_f32": [_F32P, _I, _I, _I, _F32P, _I, _I],
}

_lock = threading.Lock()
_lib = None
build_seconds = None


def _ask(*args):
    try:
        return subprocess.run([CXX, *args], capture_output=True, text=True,
                              check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"native build failed: {CXX} {' '.join(args)}: "
                           f"{e}") from e


def _build():
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (" ".join(CXX_FLAGS), _ask("--version"),
                 _ask("-march=native", "-Q", "--help=target")):
        h.update(part.encode())
    so = BUILD_DIR / f"libbfsr_native_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed: {' '.join(cmd)} "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def library():
    """The loaded host library, built from ``csrc/host`` on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            so = _build()
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise RuntimeError(f"native load of {so} failed: {e}") from e
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            build_seconds = time.perf_counter() - t0
            _lib = lib
    return _lib


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a):
    return a.ctypes.data_as(_F32P)


def bilinear_resize(img_hwc, out_hw, align_corners=False):
    """Bilinear resize of an (H, W, C) array to ``out_hw`` with
    ``F.interpolate`` semantics; float32."""
    src = _f32(img_hwc)
    h, w, c = src.shape
    oh, ow = map(int, out_hw)
    dst = np.empty((oh, ow, c), np.float32)
    library().bilinear_resize_f32(_ptr(src), h, w, c, _ptr(dst), oh, ow,
                                  int(bool(align_corners)))
    return dst


def updownup_residual(lr_norm_hwc, out_hw):
    """(lr_up, residual) of a normalised LR (h, w, C): its bilinear
    upsample to ``out_hw``, and lr_up minus its up-down-up copy (down to
    (h, w), up to ``out_hw`` again); float32."""
    src = _f32(lr_norm_hwc)
    h, w, c = src.shape
    oh, ow = map(int, out_hw)
    lr_up = np.empty((oh, ow, c), np.float32)
    residual = np.empty_like(lr_up)
    library().updownup_residual_f32(_ptr(src), h, w, c, oh, ow, _ptr(lr_up),
                                    _ptr(residual))
    return lr_up, residual


def bicubic_resize(img_hwc, out_hw):
    """MATLAB-``imresize`` bicubic of an (H, W, C) array to ``out_hw``
    (antialiased when shrinking); float32 with float64 sums."""
    src = _f32(img_hwc)
    h, w, c = src.shape
    oh, ow = map(int, out_hw)
    dst = np.empty((oh, ow, c), np.float32)
    library().bicubic_resize_f32(_ptr(src), h, w, c, _ptr(dst), oh, ow)
    return dst
