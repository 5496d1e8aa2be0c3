"""Hand-written CUDA kernels: build, load, launch counts.

Every kernel source lives in ``bfsr_tpu_torch/csrc/*.cu`` and exposes a
plain C entry.  At first use, ``library()`` compiles each of them with
its own ``nvcc`` for ``sm_90a``, all at once, links the objects into one
shared library under ``bfsr_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, and loads it
with ``ctypes``.  Nothing here runs at
import time: a machine without ``nvcc`` or a card imports the package and
uses the plain twins for CPU tensors.

Each kernel wrapper (``linf_flow`` for K1 and K4, ``linf_info``,
``conv3x3`` for K3 in f32 and bf16 and for K6, ``flow_step`` for K5 in
f32 and in its two bf16 forms) dispatches
on the device of its tensors: a CPU tensor goes to its plain PyTorch twin,
a CUDA tensor launches the kernel or raises.  There is no fallback between
the two.  A wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel, and nowhere else; K6 launches K3's f32 kernel and counts under
its own name, ``conv3x3_fused``.

A model's ``freeze()`` lays out the weights its kernels read (K3's
``kweight``, K5's packs and folds) and ``stamp_layouts`` records the
versions of the model's parameters they were made from; every in-place
change (an optimizer's step, ``load_state_dict``) bumps a parameter's
version, and ``check_layouts``, once at the start of each of the model's
passes that read the layouts, raises if they are older than the
weights.  The models that own a ``freeze()`` stamp and check themselves:
``RRDBNet``, ``FlowUpsamplerNet``, ``EDSR`` and the two UNets.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# as a ``kernels`` argument (the SRFlow-LP prior trainer's twin path):
# every kernel's plain twin, on any device
TWINS = "twins"

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES = {"linf_flow_forward": 0, "linf_flow_inverse": 0,
            "linf_flow_nd_forward": 0, "linf_flow_nd_inverse": 0,
            "linf_info": 0, "conv3x3_cat": 0, "conv3x3_cat_bf16": 0,
            "conv3x3_fused": 0,
            "flow_step_forward": 0, "flow_step_reverse": 0,
            "flow_step_bf16_forward": 0, "flow_step_bf16_reverse": 0,
            "flow_step_bf16_pallas_forward": 0,
            "flow_step_bf16_pallas_reverse": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry name -> argtypes (every entry returns cudaGetLastError() as int)
_SIGNATURES = {
    "linf_flow_forward": [_P, _P, _P, _P, _P, _I, _I, _P],
    "linf_flow_inverse": [_P, _P, _P, _P, _P, _I, _I, _P],
    "linf_flow_nd_forward": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "linf_flow_nd_inverse": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "linf_info": [_P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "conv3x3_cat": [_I, ctypes.POINTER(_P), ctypes.POINTER(_P),
                    ctypes.POINTER(_I), _P, _P, _P, _I, _I, _I, _I, _I, _F,
                    _P],
    "conv3x3_cat_bf16": [_I, ctypes.POINTER(_P), ctypes.POINTER(_P),
                         ctypes.POINTER(_I), _P, _P, _P, _I, _I, _I, _I, _I,
                         _F, _P],
    "flow_step_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "flow_step_reverse": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "flow_step_bf16_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "flow_step_bf16_reverse": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "flow_step_bf16_pallas_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "flow_step_bf16_pallas_reverse": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None


def _weights_version(module):
    return sum(p._version for p in module.parameters())


def stamp_layouts(module):
    """Record that ``module``'s kernel layouts are made from its weights
    as they are now."""
    module.layout_version = _weights_version(module)


def check_layouts(module):
    """Raise if ``module``'s weights changed in place since its layouts
    were stamped (``stamp_layouts``)."""
    if getattr(module, "layout_version", None) not in (
            None, _weights_version(module)):
        raise RuntimeError(
            f"the kernel layouts of a {type(module).__name__} are older than "
            "its weights (changed in place since freeze()): call freeze() "
            "again before the kernel path reads them")


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    cands = [os.environ.get("NVCC"), shutil.which("nvcc"),
             "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set NVCC or put it on PATH); the "
                       "CUDA kernels are built from bfsr_tpu_torch/csrc at "
                       "first use")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _build():
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = BUILD_DIR / f"libbfsr_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{h.hexdigest()[:16]}.{os.getpid()}"
    jobs = []
    for src in (s for s in srcs if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    try:
        for cmd, _, proc in jobs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
            logs.append(out)
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, so)
    (BUILD_DIR / "ptxas.log").write_text("".join(logs))
    return so


def library():
    """The loaded kernel library, built from ``csrc/`` on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            so = _build()
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            build_seconds = time.perf_counter() - t0
            _lib = lib
    return _lib


def launch(name, *args, counter=None):
    """Call C entry ``name`` on the current stream and count the launch
    under ``counter`` (default: ``name``); raise if it reports a CUDA
    error."""
    fn = getattr(library(), name)
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{err}")
    LAUNCHES[counter or name] += 1


def ptr(t):
    """A tensor's device pointer; None gives a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check_cuda(name, *tensors):
    """Validate what every kernel takes: f32, contiguous, one CUDA device
    (a kernel's bf16 weight buffer is checked by its wrapper)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
