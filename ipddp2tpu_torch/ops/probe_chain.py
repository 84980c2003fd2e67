"""Two probes of the card's arithmetic over T dependent steps.

They replace the two probe kernels of `scripts/tpu_dd_probe.py` (`kern_mul`,
`kern_dyn`), which asked whether double-single arithmetic survives a 100-step
recursion inside a TPU kernel. On this card the types are native and the
question stays: does a chain of T dependent steps inside one kernel
(`csrc/probe_chain.cu`) land where the same chain lands in plain PyTorch?

`mul_chain_cuda(x0, c, steps)` multiplies every element by `c`, `steps`
times, one thread an element: a chain of dependent multiplies, bound by the
multiply's latency per step and the launch. `dynamics_chain_cuda(x0, u)`
steps the concar dynamics (the device function the forward kernels use)
from `x0 [B, 4]` under `u [B, T, 10]` and returns `x_T`, one thread an
instance. Its controls are staged ahead of the chain: a block of
`chain_geometry(B, T, dtype).instances_per_block` instances brings each
instance's row of controls into shared memory a window of steps at a time,
by TMA bulk copies into a ring of two windows, so that no step waits on
device memory; the arithmetic is the device function's, unchanged.
`chain_geometry` lays the launch out (blocks, window, the padded row,
shared memory) and the wrapper passes it to the kernel.

Plain versions: `mul_chain_plain`, `dynamics_chain_plain`. CPU tensors take
the plain version, CUDA tensors launch the kernel or raise. The byte bound
of both is the inputs read once. `empty_cuda` launches a kernel that does
nothing at a given geometry: the floor of one launch, timed beside them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build as _build
from ..derivatives import batched_dynamics
from ..models import concar

SOURCE = _build.CSRC / "probe_chain.cu"

launch_counts = {"mul_chain_f32": 0, "mul_chain_f64": 0,
                 "dynamics_chain_f32": 0, "dynamics_chain_f64": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_libs = {}

# the dynamics chain's layout (csrc/probe_chain.cu): instances a block (a
# thread each), steps a window, windows a block holds at once
INSTANCES_PER_BLOCK = 16
WINDOW = 20
SLOTS = 2


class ChainGeometry(NamedTuple):
    """How the dynamics chain is launched on B instances of T steps."""

    instances_per_block: int    # threads a block
    blocks: int
    window: int                 # steps a bulk copy brings in
    windows: int                # copies a row takes
    row_steps: int              # steps a row of u holds: T, padded to
    #                             16-byte rows (a float row of odd T + 1)
    smem_bytes: int             # the ring: SLOTS windows of every instance


def chain_geometry(B: int, T: int, dtype) -> ChainGeometry:
    """The launch of `dynamics_chain_cuda` on B instances of T steps. A
    bulk copy wants 16-byte sources, targets and sizes: a window's bytes
    (WINDOW steps of 10 controls) are a multiple of 16 in both types, and a
    row's are made one by a padding step where they are not (float, odd
    T)."""
    step_bytes = concar.NU * torch.finfo(dtype).bits // 8
    row_steps = T
    while row_steps * step_bytes % 16:
        row_steps += 1
    ipb = INSTANCES_PER_BLOCK
    return ChainGeometry(ipb, -(-B // ipb), WINDOW, -(-T // WINDOW),
                         row_steps, SLOTS * ipb * WINDOW * step_bytes)


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
            d.restype, d.argtypes = i, [p, p, p, i, i, i, i, i, i, p]
        lib.empty_launch.restype = i
        lib.empty_launch.argtypes = [i, i, i, p]
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
    geo = chain_geometry(B, T, x0.dtype)
    if geo.row_steps != T:
        u = torch.nn.functional.pad(u, (0, 0, 0, geo.row_steps - T))
    x0, u = x0.contiguous(), _build.dense(u)
    out = torch.empty_like(x0)
    _launch("dynamics_chain", x0, x0.data_ptr(), u.data_ptr(),
            out.data_ptr(), B, T, geo.row_steps, geo.instances_per_block,
            geo.window, geo.smem_bytes)
    return out


def empty_cuda(blocks: int, threads: int, smem_bytes: int = 0,
               device="cuda"):
    """Launch a kernel that does nothing on `blocks` x `threads` with
    `smem_bytes` of shared memory a block (not counted)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"empty_cuda: unsupported device {device}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().empty_launch(blocks, threads, smem_bytes,
                                      ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"empty_launch: launch refused, CUDA error {err}")
