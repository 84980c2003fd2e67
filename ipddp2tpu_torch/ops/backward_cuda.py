"""The backward-sweep CUDA kernel: build, binding and wrapper.

`backward_sweep_cuda` runs one whole backward sweep for a batch of instances
in ONE kernel launch (`csrc/backward_sweep.cu`). It replaces the TPU kernels
`ipddp2tpu/ops/backward_pallas.py::backward_sweep_pallas` (float32
instantiation) and
`ipddp2tpu/ops/backward_pallas_df64.py::backward_sweep_pallas_df64` (float64
instantiation, native FP64 instead of double-single pairs) and keeps their
signature without `tile_b`/`interpret`. Its plain PyTorch version is
`ipddp2tpu_torch.backward.sweep_plain`; the wrapper takes it only for
tensors that lie on the CPU. For CUDA tensors it launches the kernel or
raises — there is no fallback.

Bound on this card: the sweep is a chain of T dependent m x m factorizations
per instance, so it is bound by latency (neither by the bytes it moves nor
by the FP64 rate); the kernel's answer is one thread per instance with the
carry and the pivoted matrices in shared memory, see the source's header.

Build: `nvcc` compiles the source for `sm_90a` into a shared library with a
plain C interface, one per (nx, nu, nc), under `ops/_build/` at first use;
`ctypes` binds it. Nothing is built or imported from CUDA at module import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "backward_sweep.cu"
BUILD_DIR = _HERE / "_build"

# launches made by the wrapper, per kernel name; a run that must show it
# went through the kernel sets them to 0 before and reads them after
launch_counts = {"backward_sweep_f32": 0, "backward_sweep_f64": 0}

_KERNEL_OF = {torch.float32: "backward_sweep_f32",
              torch.float64: "backward_sweep_f64"}
_libs = {}
_N_PTRS = 33


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc): cannot build "
                           "the backward-sweep kernel")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _lib_path(nx: int, nu: int, nc: int) -> Path:
    tag = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"backward_sweep_nx{nx}_nu{nu}_nc{nc}_{tag}.so"


def start_build(nx: int, nu: int, nc: int, verbose: bool = False):
    """Start `nvcc` for one (nx, nu, nc) without waiting. Returns
    (process or None if already built, temporary path, final path). Several
    builds started together run in parallel; `finish_build` waits."""
    out = _lib_path(nx, nu, nc)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           f"-DNX={nx}", f"-DNU={nu}", f"-DNC={nc}"]
    if verbose:
        cmd.append("-Xptxas=-v")
    cmd += ["-o", str(tmp), str(SOURCE)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def finish_build(proc, tmp, out, verbose: bool = False) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {out.name}:\n{log}")
    if verbose and log:
        print(log, flush=True)
    os.replace(tmp, out)
    return out


def build(dims, verbose: bool = False):
    """Build the libraries for every (nx, nu, nc) in `dims`, all `nvcc`
    processes started together. Raises on any failure."""
    started = [start_build(*d, verbose=verbose) for d in dims]
    return [finish_build(*s, verbose=verbose) for s in started]


def _library(nx: int, nu: int, nc: int):
    key = (nx, nu, nc)
    lib = _libs.get(key)
    if lib is None:
        path, = build([key])
        lib = ctypes.CDLL(str(path))
        for name in _KERNEL_OF.values():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_double,
                           ctypes.c_void_p]
        _libs[key] = lib
    return lib


def _expected_shapes(B, T, nx, nu, nc):
    nz = nx + nu
    return dict(
        fx=(B, T, nx, nx), fu=(B, T, nx, nu), lx=(B, T, nx), lu=(B, T, nu),
        lxx=(B, T, nx, nx), lux=(B, T, nu, nx), luu=(B, T, nu, nu),
        cx=(B, T, nc, nx), cu=(B, T, nc, nu), sec=(B, T, nz, nz),
        c_rel=(B, T, nc), il=(B, T, nu), iu=(B, T, nu), phi=(B, T, nc),
        zl=(B, T, nu), zu=(B, T, nu), lTx=(B, nx), lTxx=(B, nx, nx),
        mu=(B,), reg=(B,), delta_c=(B,))


def backward_sweep_cuda(fx, fu, lx, lu, lxx, lux, luu, cx, cu, sec,
                        c_rel, il, iu, phi, zl, zu, lTx, lTxx,
                        mu, reg, delta_c, *, nx, nu, nc, refine, rtol,
                        profile=None):
    """Full-batch backward sweep. All per-stage arguments are batch-leading
    `[B, T, ...]`; the per-instance scalars mu/reg/delta_c are `[B]`.
    Returns ((alpha, beta, psi, omega, chi_l, zeta_l, chi_u, zeta_u) as
    `[B, T, ...]` tensors, dL [B], fail [B] bool, singular [B] bool) — one
    `backward._run_pass` attempt, batched.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    `profile`, if given, is an int64 CUDA tensor of 5 zeros to which lane 0
    of every block adds its clock cycles per section of the stage loop
    (assemble, factor, solve, gains, value); see `profile_sweep.py`.
    """
    B, T = il.shape[0], il.shape[1]
    named = dict(fx=fx, fu=fu, lx=lx, lu=lu, lxx=lxx, lux=lux, luu=luu,
                 cx=cx, cu=cu, sec=sec, c_rel=c_rel, il=il, iu=iu, phi=phi,
                 zl=zl, zu=zu, lTx=lTx, lTxx=lTxx, mu=mu, reg=reg,
                 delta_c=delta_c)
    dtype, device = il.dtype, il.device
    for name, want in _expected_shapes(B, T, nx, nu, nc).items():
        a = named[name]
        if tuple(a.shape) != want:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected {want}")
        if a.dtype != dtype or a.device != device:
            raise ValueError(
                f"{name}: {a.dtype} on {a.device}, expected {dtype} on "
                f"{device}")

    if device.type == "cpu":
        from ..backward import sweep_plain
        return sweep_plain(fx, fu, lx, lu, lxx, lux, luu, cx, cu, sec,
                           c_rel, il, iu, phi, zl, zu, lTx, lTxx,
                           mu, reg, delta_c, nx=nx, nu=nu, nc=nc,
                           refine=refine, rtol=rtol)
    if device.type != "cuda":
        raise RuntimeError(f"backward_sweep_cuda: unsupported device {device}")
    kernel = _KERNEL_OF.get(dtype)
    if kernel is None:
        raise TypeError(f"backward_sweep_cuda: unsupported dtype {dtype}")

    lib = _library(nx, nu, nc)
    # the kernel reads dense row-major [B, T, ...]; slices of a larger
    # Jacobian are packed here. The packed copies are dropped when this
    # function returns, before the kernel has run: the caching allocator
    # hands their memory only to later work on this same stream.
    ins = [named[k].contiguous() for k in named]
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    gains = (new(B, T, nu), new(B, T, nu, nx), new(B, T, nc),
             new(B, T, nc, nx), new(B, T, nu), new(B, T, nu, nx),
             new(B, T, nu), new(B, T, nu, nx))
    dL = new(B)
    fail = torch.empty((B,), dtype=torch.bool, device=device)
    singular = torch.empty((B,), dtype=torch.bool, device=device)
    tensors = ins + list(gains) + [dL, fail, singular]
    ptrs = (ctypes.c_void_p * _N_PTRS)(
        *[t.data_ptr() for t in tensors],
        None if profile is None else profile.data_ptr())

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, kernel)(ptrs, B, T, int(refine), float(rtol),
                                   ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{kernel}: launch refused, CUDA error {err} "
            f"(B={B}, T={T}, nx={nx}, nu={nu}, nc={nc})")
    launch_counts[kernel] += 1
    return gains, dL, fail, singular
