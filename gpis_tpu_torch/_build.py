"""Build, load and count the hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled once, at first use, by one `nvcc` each,
all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -c csrc/<name>.cu -o _build/<hash>/<name>.o

and the objects are linked by `nvcc -shared` into _build/<hash>/libgpis_kernels.so
(a directory keyed by a hash of the sources), which is loaded with `ctypes`.
The library has a plain C interface: each entry point takes raw device
pointers, sizes and the CUDA stream, launches, and returns
`cudaGetLastError()`.  Nothing here runs at import time, so the package
imports on machines without `nvcc` or a GPU (the CPU tests use the plain
PyTorch twins beside each kernel).

`LAUNCHES` counts kernel launches by wrapper name.  A wrapper adds one only
where it hands a CUDA tensor to its kernel, so a run can show that its main
path went through the kernels rather than the twins.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

__all__ = ["LAUNCHES", "build", "library", "call", "check_cuda_args", "check_cuda_rows",
           "resolve_device", "takes_kernel"]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
LIB_NAME = "libgpis_kernels.so"

LAUNCHES: collections.Counter = collections.Counter()

_P, _I64, _I32, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double

# C signatures of csrc/*.cu, each bound as `name_f32`, and as `name_f64` too
# for the names in _BOTH_DTYPES.  A pointer or the stream passed without
# c_void_p would be cut to 32 bits by ctypes.
_SIGNATURES = {
    # a, m, b, n, noise, sym, row0, kernel_id, ls, sv, out, stream
    "gpis_cov": [_P, _I64, _P, _I64, _P, _I32, _I64, _I32, _F64, _F64, _P, _P],
    # mat, n, j0, bw, units, n_units, tiles, n_tiles, ws, stream (the plan and
    # workspace of the tensor-core body, here and below)
    "gpis_panel_update": [_P, _I64, _I64, _I64, _P, _I64, _P, _I64, _P, _P],
    # lrow, w, n, j0, bw, out, units, n_units, tiles, n_tiles, ws, stream
    "gpis_row_update": [_P, _P, _I64, _I64, _I64, _P, _P, _I64, _P, _I64, _P, _P],
    # kq, m, w, alpha, c, partial, mean, quad, units, n_units, tiles, n_tiles, ws, stream
    "gpis_staged_quad": [_P, _I64, _P, _P, _I64, _P, _P, _P, _P, _I64, _P, _I64, _P, _P],
    # rmeta, r, cmeta, s, noise, row0, kernel_id, ls, sv, out, stream
    "gpis_joint_cov": [_P, _I64, _P, _I64, _P, _I64, _I32, _F64, _F64, _P, _P],
    # q, m, cols, c, joint, w, alpha, kernel_id, ls, sv, partial, mean, quad, units, n_units,
    # tiles, n_tiles, ws, stream
    "gpis_fused_quad": [_P, _I64, _P, _I64, _I32, _P, _P, _I32, _F64, _F64, _P, _P, _P, _P, _I64,
                        _P, _I64, _P, _P],
    # q, m, cols, c, joint, w, ldw, rows, width, row0, kernel_id, ls, sv, partial, quad, units,
    # n_units, tiles, n_tiles, ws, stream
    "gpis_quad_band": [_P, _I64, _P, _I64, _I32, _P, _I64, _I64, _I64, _I64, _I32, _F64, _F64,
                       _P, _P, _P, _I64, _P, _I64, _P, _P],
    # a, lda, r, b, ldb, p, s, lds, out, ldo, k0, units, n_units, tiles, n_tiles, ws, stream
    "gpis_gemm_nt_masked": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P, _I64, _I64, _P, _I64,
                            _P, _I64, _P, _P],
    # a, lda, r, b, ldb, k, u, ldu, w, units, n_units, tiles, n_tiles, ws, stream
    "gpis_gemm_nn_acc_masked": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P,
                                _I64, _P, _P],
    # dst, ldd, blk, ldb, r, w, c0, stream
    "gpis_stripe_write": [_P, _I64, _P, _I64, _I64, _I64, _I64, _P],
    # acc, lda, r, v, ldv, b, out, ldo, units, n_units, tiles, n_tiles, ws, stream
    "gpis_panel_scale": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P, _I64, _P, _I64, _P, _P],
    # v, ldv, b, rhs, ldr, n, out, ldo, units, n_units, tiles, n_tiles, ws, stream
    "gpis_row_scale": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P, _I64, _P, _I64, _P, _P],
    # s, lds, lcol, ldl, wj, ldw, rows, w, bw, units, n_units, tiles, n_tiles, ws, stream (s
    # and lcol at the live block's first row, `cuda_chol._trail_ranges`)
    "gpis_band_trail": [_P, _I64, _P, _I64, _P, _I64, _I64, _I64, _I64, _P, _I64, _P, _I64, _P,
                        _P],
}

# A (cov), E (joint_cov) and I (stripe_write) have one body for both dtypes;
# the tensor-core kernels take float32 only (`takes_kernel`).
_BOTH_DTYPES = ("gpis_cov", "gpis_joint_cov", "gpis_stripe_write")

_lib = None


def resolve_device(device="cuda") -> torch.device:
    """The device a caller asked for.  CUDA that is not there raises: the port
    never drops to the CPU on its own (pass device="cpu" for the twins)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain PyTorch path"
        )
    return dev


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every process; raise on the first that failed.  Returns their
    combined output."""
    log = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            for _, other in procs:
                if other.poll() is None:
                    other.kill()
                    other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        log.append(out)
    return "".join(log)


def build() -> tuple[str, float, str]:
    """Compile csrc/*.cu if the source hash has no library yet: one nvcc for
    each source, all started together, then one link.  Returns (library
    path, seconds spent compiling (0 when cached), compiler output: the
    -Xptxas -v register / shared-memory / spill report)."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path, 0.0, ""
    os.makedirs(out_dir, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    objs, compiles = [], []
    t0 = time.perf_counter()
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(src)[:-3]}.{tag}.o")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", src, "-o", obj]
        objs.append(obj)
        compiles.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    log = _run(compiles)
    tmp = f"{lib_path}.{tag}.tmp"
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs]
    log += _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))])
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return lib_path, seconds, log


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        for name, argtypes in _SIGNATURES.items():
            for suffix in ("_f32", "_f64") if name in _BOTH_DTYPES else ("_f32",):
                fn = getattr(lib, name + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


def call(name: str, like: torch.Tensor, *args) -> None:
    """Launch entry point `name` for `like`'s dtype on its device's current
    stream; raise if the launch was refused (cudaGetLastError() != 0)."""
    fn = getattr(library(), name + _SUFFIX[like.dtype])
    with torch.cuda.device(like.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}{_SUFFIX[like.dtype]} launch failed: cudaError {err}")


def takes_kernel(what: str, t: torch.Tensor) -> bool:
    """Whether a tensor-core kernel (B, C, D, F, G, H, J, K or L) gets t: a
    CUDA tensor does, a CPU tensor takes the kernel's plain twin.  Those
    kernels take float32 only, so a CUDA tensor of any other dtype raises:
    float64 runs on the CPU."""
    if t.device.type == "cpu":
        return False
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: dtype {t.dtype} not supported on {t.device} (float32; "
                        "float64 runs on device='cpu')")
    return True


def _check_device_dtype(what: str, tensors) -> None:
    dt = tensors[0].dtype
    if dt not in _SUFFIX:
        raise TypeError(f"{what}: dtype {dt} not supported (float32 or float64)")
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != dt:
            raise TypeError(f"{what}: mixed dtypes {dt} and {t.dtype}")
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: all tensors must be on one CUDA device")


def check_cuda_args(what: str, *tensors: torch.Tensor) -> None:
    """Wrapper-side validation before raw pointers reach a kernel: one CUDA
    device, one dtype (float32, or float64), contiguous row-major storage."""
    _check_device_dtype(what, tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def check_cuda_rows(what: str, *mats: torch.Tensor) -> None:
    """The same for kernels that take each (R, C) operand as a row-major view
    with its own leading dimension `stride(0)`: elements of a row adjacent,
    rows not overlapping.  Column slices of a wider matrix pass; a transposed
    view does not."""
    _check_device_dtype(what, mats)
    for t in mats:
        if t.ndim != 2:
            raise ValueError(f"{what}: expected matrices, got shape {tuple(t.shape)}")
        rows, cols = t.shape
        if (cols > 1 and t.stride(1) != 1) or (rows > 1 and t.stride(0) < cols):
            raise ValueError(f"{what}: operand of shape {tuple(t.shape)} and strides "
                             f"{t.stride()} is not a row-major view")
