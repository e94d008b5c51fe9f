"""Build and load the package's CUDA kernels (``src/repro_torch/csrc``).

At first use, every ``csrc/*.cu`` file is compiled for Hopper by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface, loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC

The library lands in ``build/repro_torch/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is. A missing ``nvcc`` or a
failed build raises; nothing falls back to the plain versions.

Pointers and the stream go to the C functions as ``c_void_p`` (a Python int
from ``tensor.data_ptr()`` / ``torch.cuda.current_stream().cuda_stream``),
strides as ``c_longlong`` (the attention kernels take theirs as one host
array, built by :func:`strides_arg`), scalars as ``c_float`` and sizes as
``c_int``. Each launch function returns ``cudaGetLastError()``;
:func:`check` raises on a nonzero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PACKAGE = pathlib.Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE.parents[1] / "build" / "repro_torch"
LIB_NAME = "librepro_kernels.so"
CUDA_NVCC = pathlib.Path("/usr/local/cuda/bin/nvcc")

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")

#: dtype codes of csrc/common.cuh
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)   # host array of strides
_IP = ctypes.POINTER(ctypes.c_int)        # host array of ints (out)

#: argtypes of the C entry points that return an int
_SIGNATURES = {
    "gram_norm_blocks": (_I, _I),
    "gram_norm_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _L, _L, _L, _L, _I, _I, _P, _I, _I, _I, _I, _I,
                         _P),
    "gram_norm_kernel_info": (_IP,),
    "direct_norm_blocks": (_I, _I, _I),
    "direct_norm_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _L, _L, _L, _L, _I, _I, _P),
    "direct_norm_kernel_info": (_IP,),
    "segmented_norm_tiles": (_I, _I),
    "segmented_norm_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _L, _L, _I, _I, _I, _P),
    "segmented_norm_kernel_info": (_IP,),
    "rowsumsq_launch": (_P, _P, _I, _I, _I, _I, _L, _L, _P),
    "rowsumsq_kernel_info": (_I, _I, _IP),
    "clip_scale_launch": (_P, _P, _P, _I, _I, _I, _I, _L, _L, _P),
    "clip_scale_kernel_info": (_I, _IP),
    "flash_attention_fwd_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _F, _I, _LP, _I, _P),
    "flash_attention_bwd_dq_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _I, _I, _F, _F, _I, _LP,
                                      _I, _P),
    "flash_attention_bwd_dkv_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _I, _F, _F, _I,
                                       _LP, _I, _P, _I, _P),
    "flash_attention_kernel_info": (_I, _I, _IP),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_NVCC.exists():
        return str(CUDA_NVCC)
    raise RuntimeError(
        f"nvcc not found (looked on PATH and at {CUDA_NVCC}): the CUDA "
        f"kernels of repro_torch are built from source at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> pathlib.Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def _run_all(cmds):
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if p.returncode != 0:
            failed.append(cmd)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"building the repro_torch CUDA kernels failed:\n"
                           f"{log}")
    return log


def build() -> pathlib.Path:
    """Compile the sources into ``lib_path()`` unless it already exists."""
    target = lib_path()
    if target.exists():
        return target
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        log = _run_all([[nvcc, *FLAGS, "-c", str(src), "-o", obj]
                        for src, obj in zip(_sources(), objs)])
        lib_tmp = os.path.join(tmp, LIB_NAME)
        log += "\n" + _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp,
                                 *objs]])
        (target.parent / "build.log").write_text(log)
        os.replace(lib_tmp, target)
    return target


def build_log() -> str:
    """Compiler output of the build (registers, shared memory, spills)."""
    path = lib_path().parent / "build.log"
    return path.read_text() if path.exists() else ""


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built at first use; argtypes set for every C
    entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = load().repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def dtype_code(t) -> int:
    key = str(t.dtype)
    if key not in DTYPE_CODES:
        raise TypeError(f"the package's CUDA kernels take float32 or "
                        f"bfloat16, got {t.dtype}")
    return DTYPE_CODES[key]


def strides_arg(tensors):
    """The (batch, head, sequence) element strides of each tensor, in
    order, as the host ``long long`` array the attention launches take."""
    vals = [t.stride(d) for t in tensors for d in (0, 1, 2)]
    return (ctypes.c_longlong * len(vals))(*vals)


#: the fields of a kernel_info() reading, in the C functions' order
INFO_KEYS = ("registers", "local_bytes", "smem_bytes", "threads",
             "blocks_per_sm")


def aligned_rows(*tensors) -> bool:
    """Every tensor's base and every stride but the last (which is 1) are
    multiples of 16 bytes: its rows can be copied in 16-byte pieces."""
    return all(t.data_ptr() % 16 == 0
               and all(t.stride(d) * t.element_size() % 16 == 0
                       for d in range(t.ndim - 1))
               for t in tensors)


def copy_route(*tensors) -> str:
    """How a bf16 kernel brings these inputs into shared memory: ``"tma"``
    when their rows are aligned (:func:`aligned_rows`), so a tensor map can
    describe them; else ``"synchronous"`` (loads and stores into the same
    tiles). The launchers pass it to the kernels, which take no other
    rule."""
    return "tma" if aligned_rows(*tensors) else "synchronous"


def pair_inputs(h, zbar, what: str):
    """Check an (h, zbar) pair for the norm kernels and return it with the
    feature axis contiguous (a copy only where it was not): both on one
    CUDA device, (B, S, P) with the same B and S, one dtype."""
    if h.device.type != "cuda" or zbar.device != h.device:
        raise ValueError(f"{what}: the kernel takes CUDA tensors on one "
                         f"device, got {h.device} and {zbar.device}")
    if h.ndim != 3 or zbar.ndim != 3 or h.shape[:2] != zbar.shape[:2]:
        raise ValueError(f"{what}: expected h (B, S, p_in) and zbar "
                         f"(B, S, p_out), got {tuple(h.shape)} and "
                         f"{tuple(zbar.shape)}")
    if h.dtype != zbar.dtype:
        raise TypeError(f"{what}: h and zbar differ in dtype "
                        f"({h.dtype} vs {zbar.dtype})")
    dtype_code(h)
    if h.stride(-1) != 1:
        h = h.contiguous()
    if zbar.stride(-1) != 1:
        zbar = zbar.contiguous()
    return h, zbar
