"""Two probes of the card's arithmetic over T dependent steps.

They replace the two probe kernels of `scripts/tpu_dd_probe.py` (`kern_mul`,
`kern_dyn`), which asked whether double-single arithmetic survives a 100-step
recursion inside a TPU kernel. On this card the types are native and the
question stays: does a chain of T dependent steps inside one kernel
(`csrc/probe_chain.cu`) land where the same chain lands in plain PyTorch?

`mul_chain_cuda(x0, c, steps)` multiplies every element by `c`, `steps`
times; `dynamics_chain_cuda(x0, u)` steps the concar dynamics (the device
function the forward kernels use) from `x0 [B, 4]` under `u [B, T, 10]` and
returns `x_T`. Plain versions: `mul_chain_plain`, `dynamics_chain_plain`.
CPU tensors take the plain version, CUDA tensors launch the kernel or raise.
Both chains are bound by latency; their byte bound is the inputs read once.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build
from ..derivatives import batched_dynamics
from ..models import concar

SOURCE = _build.CSRC / "probe_chain.cu"

launch_counts = {"mul_chain_f32": 0, "mul_chain_f64": 0,
                 "dynamics_chain_f32": 0, "dynamics_chain_f64": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_libs = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def start_build(verbose: bool = False):
    """Start `nvcc` for the probes' library without waiting."""
    return _build.start(
        "probe_chain", SOURCE,
        depends=(_build.CSRC / "models" / "concar.cuh",
                 _build.CSRC / "scalar_math.cuh"), verbose=verbose)


def _library():
    lib = _libs.get("probe_chain")
    if lib is None:
        lib = ctypes.CDLL(str(_build.finish(start_build())))
        p, i = ctypes.c_void_p, ctypes.c_int
        for sfx in _SUFFIX.values():
            m = getattr(lib, f"mul_chain_{sfx}")
            m.restype, m.argtypes = i, [p, p, i, i, ctypes.c_double, p]
            d = getattr(lib, f"dynamics_chain_{sfx}")
            d.restype, d.argtypes = i, [p, p, p, i, i, p]
        _libs["probe_chain"] = lib
    return lib


def _launch(name, tensor, *args):
    if tensor.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {tensor.device}")
    sfx = _SUFFIX.get(tensor.dtype)
    if sfx is None:
        raise TypeError(f"{name}: unsupported dtype {tensor.dtype}")
    kernel = f"{name}_{sfx}"
    with torch.cuda.device(tensor.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_library(), kernel)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{kernel}: launch refused, CUDA error {err}")
    launch_counts[kernel] += 1


def mul_chain_plain(x0, c: float, steps: int):
    """x <- x * c, `steps` times, in the tensor's own type."""
    x = x0
    c = torch.as_tensor(c, dtype=x0.dtype, device=x0.device)
    for _ in range(steps):
        x = x * c
    return x


def mul_chain_cuda(x0, c: float, steps: int):
    if x0.device.type == "cpu":
        return mul_chain_plain(x0, c, steps)
    x0 = x0.contiguous()
    out = torch.empty_like(x0)
    _launch("mul_chain", x0, x0.data_ptr(), out.data_ptr(), x0.numel(),
            int(steps), float(c))
    return out


def dynamics_chain_plain(x0, u):
    """T steps of `models.concar.dynamics` from `x0 [B, 4]` under
    `u [B, T, 10]`; returns `x_T [B, 4]`."""
    step = batched_dynamics(concar.problem())
    x = x0
    for t in range(u.shape[1]):
        x = step(x, u[:, t], t, None)
    return x


def dynamics_chain_cuda(x0, u):
    B, T = u.shape[0], u.shape[1]
    if tuple(x0.shape) != (B, concar.NX) or tuple(u.shape) != (B, T,
                                                               concar.NU):
        raise ValueError(f"x0 {tuple(x0.shape)}, u {tuple(u.shape)}: "
                         f"expected [B, {concar.NX}] and [B, T, {concar.NU}]")
    if u.dtype != x0.dtype or u.device != x0.device:
        raise ValueError("x0 and u differ in dtype or device")
    if x0.device.type == "cpu":
        return dynamics_chain_plain(x0, u)
    x0, u = x0.contiguous(), u.contiguous()
    out = torch.empty_like(x0)
    _launch("dynamics_chain", x0, x0.data_ptr(), u.data_ptr(),
            out.data_ptr(), B, T)
    return out

