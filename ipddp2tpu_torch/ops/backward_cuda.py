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
by the FP64 rate). The kernel's answer: a group of G lanes of a warp owns an
instance (G the smallest power of two >= m = nu + nc, at most 32), lane i
holding row i of the KKT system, so that pivot search, elimination,
substitution and assembly each take m short steps on every lane instead of
m*m on one thread, and the stage inputs arrive in shared memory by
asynchronous copies one stage ahead; see the source's header. For 32 < m
<= 64 (cartpole's m = 35 with `inertia_method="ldl"`) the same sweep runs
with a warp an instance, two rows a lane and the working matrix in shared
memory (`csrc/backward_sweep_wide.cuh`, chosen by the size at build time).
`launch_geometry` computes G, the instances per block and the block's shared
memory here in Python, and refuses m > 64 and blocks above the card's
227 KB.

The stage solve is a compile-time choice of the same source. The LDL^T
instantiation above serves `inertia_method="ldl"` (and "auto" where it
resolves to it). The Bunch-Kaufman instantiation (`-DSWEEP_BK=1`,
`csrc/backward_sweep_bk.cuh`) serves `inertia_method="bk"`, the contact
models' oracle: rook-pivoted Bunch-Kaufman with the reference's inertia
count and plain substitution, one warp an instance and its KKT matrix in
shared memory, so m = nu + nc up to `MAX_KKT_WARP`; its plain version is
`sweep_plain(..., inertia="bk")`. `launch_geometry(..., inertia=...)` and
the launch counts are per instantiation. The eigh oracle has no kernel.

Prepare and launch are two steps. Of the 21 inputs only `reg` and `delta_c`
change between the attempts of the regularization ladder, so
`prepare_sweep` checks and packs the other 19 once per backward pass and
`sweep_prepared` launches one attempt on them. `backward_sweep_cuda` is
both in one call.

Build: `nvcc` compiles the source for `sm_90a` into a shared library with a
plain C interface, one per (nx, nu, nc), under `ops/_build/` at first use;
`ctypes` binds it. Nothing is built or imported from CUDA at module import.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build as _build
from .build import SMEM_LIMIT, dense

SOURCE = _build.CSRC / "backward_sweep.cu"

# launches made by the wrapper, per kernel name; a run that must show it
# went through the kernel sets them to 0 before and reads them after
launch_counts = {"backward_sweep_f32": 0, "backward_sweep_f64": 0,
                 "backward_sweep_bk_f32": 0, "backward_sweep_bk_f64": 0}

# the C functions of a library, by type (both instantiations name them so)
_FUNCTION_OF = {torch.float32: "backward_sweep_f32",
                torch.float64: "backward_sweep_f64"}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
INERTIA = ("ldl", "bk")        # the stage solves with a kernel
_libs = {}
_N_PTRS = 33
# the largest group of lanes that can own an instance (one warp): the LDL^T
# sweep of a larger m deals its rows over a warp's lanes
MAX_KKT = 32
# the largest m of both instantiations when a warp owns an instance and its
# matrix lies in shared memory; beyond it a block would not fit anyway
MAX_KKT_WARP = 64
# the inputs that stay the same over the attempts of one backward pass
_FIXED = ("fx", "fu", "lx", "lu", "lxx", "lux", "luu", "cx", "cu", "sec",
          "c_rel", "il", "iu", "phi", "zl", "zu", "lTx", "lTxx", "mu")


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def kernel_name(dtype, inertia: str = "ldl") -> str:
    """The launch-count key of the instantiation that serves `inertia`."""
    tag = "bk_" if inertia == "bk" else ""
    return f"backward_sweep_{tag}{_SUFFIX[dtype]}"


def _refuse_inertia(inertia: str):
    if inertia not in INERTIA:
        raise ValueError(
            f"backward sweep kernel: inertia {inertia!r} has no kernel "
            f"(kernels: {INERTIA}); the eigh oracle runs the plain sweep")


class Geometry(NamedTuple):
    """How a sweep is laid over the card for one (nx, nu, nc)."""

    lanes: int                  # G: lanes of a warp that own one instance
    instances_per_block: int
    threads: int                # per block
    smem_bytes: dict            # per block, by torch dtype


def _instance_values(nx: int, nu: int, nc: int, itemsize: int,
                     inertia: str = "ldl") -> int:
    """Values of shared memory per instance: the layout `Lay<T>` (ldl) or
    `LayBK<T>` (bk) of the source, every run of the two stage buffers padded
    to 16 bytes."""
    a = 16 // itemsize
    up = lambda n: (n + a - 1) // a * a
    m, nk, nz = nu + nc, nx + 1, nx + nu
    runs = (nx * nx, nx * nu, nx, nu, nx * nx, nu * nx, nu * nu, nc * nx,
            nc * nu, nz * nz, nc, nu, nu, nc, nu, nu)
    stage = sum(up(n) for n in runs)
    if inertia == "bk":
        # A [m][m+1], rhs / forward / backward / solution [m][nk], C, Vxx,
        # Vx, Vx', D, e, perm, 4 m multipliers
        rest = (m * (m + 1) + 4 * m * nk + 2 * nx * nx + 2 * nx + 3 * m
                + 4 * m)
    elif m > MAX_KKT:
        # `LayW<T>`: K and the working copy [m][m+1], L [m][m+1], rhs and
        # solution [m][nk], C, Vxx, Vx, Vx', pivot order
        rest = (3 * m * (m + 1) + 2 * m * nk + 2 * nx * nx + 2 * nx + m)
    else:
        lanes = 1 << max(m - 1, 0).bit_length()
        rest = (m * (m + 1) + m * (lanes + 1) + 2 * m * nk + 2 * nx * nx
                + 2 * nx + m)
    return up(2 * stage + rest)


def launch_geometry(nx: int, nu: int, nc: int,
                    inertia: str = "ldl") -> Geometry:
    """G, instances per block, threads and shared-memory bytes per block of
    the instantiation that serves `inertia` ("ldl" or "bk"). A block is 4
    warps where its float64 shared memory fits the card's 227 KB, else 2,
    else 1. The LDL^T kernel: G the smallest power of two >= m = nu + nc
    up to m = 32, G = 32 (a warp an instance, two rows a lane) for 32 < m.
    The Bunch-Kaufman kernel: G = 32. Both take m up to `MAX_KKT_WARP` and
    raise ValueError above it, and for dimensions whose smallest block does
    not fit."""
    _refuse_inertia(inertia)
    m = nu + nc
    if m < 1 or min(nx, nu) < 1 or nc < 0:
        raise ValueError(f"backward sweep: bad dimensions nx={nx}, nu={nu}, "
                         f"nc={nc}")
    if m > MAX_KKT_WARP:
        raise ValueError(
            f"backward sweep kernel ({inertia}): KKT size nu + nc = {m} > "
            f"{MAX_KKT_WARP}: a warp owns an instance and its matrix lies in "
            'shared memory; use backward_kernel="torch" for this problem')
    if inertia == "bk" or m > MAX_KKT:
        lanes = 32
    else:
        lanes = 1 << (m - 1).bit_length()
    per_instance = {dt: _instance_values(nx, nu, nc, size, inertia) * size
                    for dt, size in ((torch.float32, 4), (torch.float64, 8))}
    for warps in (4, 2, 1):
        ipb = warps * 32 // lanes
        smem = {dt: v * ipb for dt, v in per_instance.items()}
        if smem[torch.float64] <= SMEM_LIMIT:
            return Geometry(lanes, ipb, ipb * lanes, smem)
    raise ValueError(
        f"backward sweep kernel: nx={nx}, nu={nu}, nc={nc} needs "
        f"{smem[torch.float64]} bytes of shared memory for one warp of "
        f"instances, the card has {SMEM_LIMIT} (227 KB) a block")


def start_build(nx: int, nu: int, nc: int, verbose: bool = False,
                defines=(), inertia: str = "ldl"):
    """Start `nvcc` for one (nx, nu, nc) and stage solve without waiting;
    `build.finish` waits. Several builds started together run in parallel.
    `defines` are further `-D` flags (a variant of the source, built beside
    the usual library under a name of its own)."""
    geo = launch_geometry(nx, nu, nc, inertia)
    tag = "".join("_" + d.replace("=", "") for d in defines)
    solve = "bk_" if inertia == "bk" else ""
    bk = ("SWEEP_BK=1",) if inertia == "bk" else ()
    return _build.start(f"backward_sweep_{solve}nx{nx}_nu{nu}_nc{nc}{tag}",
                        SOURCE,
                        defines=(f"NX={nx}", f"NU={nu}", f"NC={nc}",
                                 f"IPB={geo.instances_per_block}", *bk,
                                 *defines),
                        depends=(_build.CSRC / "async_copy.cuh",
                                 _build.CSRC / "backward_sweep_bk.cuh",
                                 _build.CSRC / "backward_sweep_wide.cuh"),
                        verbose=verbose)


def build(dims, verbose: bool = False):
    """Build the LDL^T libraries for every (nx, nu, nc) in `dims`, all
    `nvcc` processes started together. Raises on any failure."""
    return _build.finish_all([start_build(*d, verbose=verbose)
                              for d in dims], verbose=verbose)


def _load(nx: int, nu: int, nc: int, defines=(), inertia: str = "ldl"):
    path = _build.finish(start_build(nx, nu, nc, defines=defines,
                                     inertia=inertia))
    return bind(path, nx, nu, nc, inertia)


def bind(path, nx: int, nu: int, nc: int, inertia: str = "ldl"):
    """Open a built sweep library and check that it was built for these
    dimensions and the geometry `launch_geometry` computes (also a library
    built from another checkout's source, to time it against this one)."""
    geo = launch_geometry(nx, nu, nc, inertia)
    lib = ctypes.CDLL(str(path))
    for name in _FUNCTION_OF.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_double,
                       ctypes.c_void_p]
    lib.backward_sweep_dims.restype = ctypes.c_int
    lib.backward_sweep_dims.argtypes = [ctypes.POINTER(ctypes.c_int)]
    built = (ctypes.c_int * 8)()
    lib.backward_sweep_dims(built)
    want = [nx, nu, nc, geo.lanes, geo.instances_per_block, geo.threads,
            geo.smem_bytes[torch.float32], geo.smem_bytes[torch.float64]]
    if list(built) != want:
        raise RuntimeError(f"{path.name} was built as {list(built)}, "
                           f"the wrapper computed {want}")
    return lib


def _library(nx: int, nu: int, nc: int, inertia: str = "ldl"):
    key = (nx, nu, nc, inertia)
    if key not in _libs:
        _libs[key] = _load(nx, nu, nc, inertia=inertia)
    return _libs[key]


def use_variant(nx: int, nu: int, nc: int, defines=()):
    """Make the LDL^T library built with the further `-D` flags `defines`
    the one that the wrapper launches for these dimensions from now on (no
    flags: the usual one). For `profile_sweep`, which times variants of the
    source in turns inside one process."""
    _libs[(nx, nu, nc, "ldl")] = _load(nx, nu, nc, tuple(defines))


def _expected_shapes(B, T, nx, nu, nc):
    nz = nx + nu
    return dict(
        fx=(B, T, nx, nx), fu=(B, T, nx, nu), lx=(B, T, nx), lu=(B, T, nu),
        lxx=(B, T, nx, nx), lux=(B, T, nu, nx), luu=(B, T, nu, nu),
        cx=(B, T, nc, nx), cu=(B, T, nc, nu), sec=(B, T, nz, nz),
        c_rel=(B, T, nc), il=(B, T, nu), iu=(B, T, nu), phi=(B, T, nc),
        zl=(B, T, nu), zu=(B, T, nu), lTx=(B, nx), lTxx=(B, nx, nx),
        mu=(B,), reg=(B,), delta_c=(B,))


def _check(named, want, dtype, device):
    for name, a in named.items():
        if tuple(a.shape) != want[name]:
            raise ValueError(
                f"{name}: shape {tuple(a.shape)}, expected {want[name]}")
        if a.dtype != dtype or a.device != device:
            raise ValueError(
                f"{name}: {a.dtype} on {a.device}, expected {dtype} on "
                f"{device}")


class SweepInputs(NamedTuple):
    """What `prepare_sweep` returns: the 19 inputs that the attempts of one
    backward pass share, checked and (on a GPU) packed for the kernel."""

    tensors: tuple              # in the order of `_FIXED`
    nx: int
    nu: int
    nc: int
    inertia: str = "ldl"        # the stage solve: "ldl" or "bk"


def prepare_sweep(fx, fu, lx, lu, lxx, lux, luu, cx, cu, sec,
                  c_rel, il, iu, phi, zl, zu, lTx, lTxx, mu, *, nx, nu, nc,
                  inertia="ldl"):
    """Check the inputs that stay fixed over the attempts of a backward pass
    and, for CUDA tensors, pack them dense for the kernel (slices of a larger
    Jacobian are copied here, once). CPU tensors are kept as they are.
    `inertia` chooses the instantiation ("ldl" or "bk")."""
    _refuse_inertia(inertia)
    B, T = il.shape[0], il.shape[1]
    named = dict(zip(_FIXED, (fx, fu, lx, lu, lxx, lux, luu, cx, cu, sec,
                              c_rel, il, iu, phi, zl, zu, lTx, lTxx, mu)))
    dtype, device = il.dtype, il.device
    _check(named, _expected_shapes(B, T, nx, nu, nc), dtype, device)
    if device.type == "cpu":
        return SweepInputs(tuple(named.values()), nx, nu, nc, inertia)
    if device.type != "cuda":
        raise RuntimeError(f"backward_sweep_cuda: unsupported device {device}")
    if dtype not in _FUNCTION_OF:
        raise TypeError(f"backward_sweep_cuda: unsupported dtype {dtype}")
    launch_geometry(nx, nu, nc, inertia)   # refuses what it cannot take
    return SweepInputs(tuple(dense(a) for a in named.values()), nx, nu, nc,
                       inertia)


def sweep_prepared(prepared: SweepInputs, reg, delta_c, *, refine, rtol,
                   atol=1e-12, profile=None):
    """One sweep attempt at `reg`, `delta_c` (`[B]`) on prepared inputs;
    returns what `backward_sweep_cuda` returns. The LDL^T instantiation
    reads `refine` and `rtol`, the Bunch-Kaufman one `atol`."""
    nx, nu, nc = prepared.nx, prepared.nu, prepared.nc
    inertia = prepared.inertia
    il, mu = prepared.tensors[11], prepared.tensors[18]
    B, T = il.shape[0], il.shape[1]
    dtype, device = il.dtype, il.device
    _check(dict(reg=reg, delta_c=delta_c), dict(reg=(B,), delta_c=(B,)),
           dtype, device)

    if device.type == "cpu":
        from ..backward import sweep_plain
        return sweep_plain(*prepared.tensors, reg, delta_c, nx=nx, nu=nu,
                           nc=nc, refine=refine, rtol=rtol, inertia=inertia,
                           atol=atol)

    kernel = kernel_name(dtype, inertia)
    lib = _library(nx, nu, nc, inertia)
    # reg and delta_c are dropped when this function returns, before the
    # kernel has run: the caching allocator hands their memory only to
    # later work on this same stream
    ins = list(prepared.tensors) + [reg.contiguous(), delta_c.contiguous()]
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
        tol = atol if inertia == "bk" else rtol
        err = getattr(lib, _FUNCTION_OF[dtype])(ptrs, B, T, int(refine),
                                                float(tol),
                                                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{kernel}: launch refused, CUDA error {err} "
            f"(B={B}, T={T}, nx={nx}, nu={nu}, nc={nc})")
    launch_counts[kernel] += 1
    return gains, dL, fail, singular


def backward_sweep_cuda(fx, fu, lx, lu, lxx, lux, luu, cx, cu, sec,
                        c_rel, il, iu, phi, zl, zu, lTx, lTxx,
                        mu, reg, delta_c, *, nx, nu, nc, refine, rtol,
                        inertia="ldl", atol=1e-12, profile=None):
    """Full-batch backward sweep. All per-stage arguments are batch-leading
    `[B, T, ...]`; the per-instance scalars mu/reg/delta_c are `[B]`.
    Returns ((alpha, beta, psi, omega, chi_l, zeta_l, chi_u, zeta_u) as
    `[B, T, ...]` tensors, dL [B], fail [B] bool, singular [B] bool) — one
    `backward._run_pass` attempt, batched: `prepare_sweep`, then
    `sweep_prepared`.

    `inertia` chooses the instantiation: "ldl" (refine, rtol) or "bk"
    (atol). CPU tensors take the plain version; CUDA tensors launch the
    kernel.
    `profile`, if given, is an int64 CUDA tensor of 5 zeros to which thread
    0 of every block adds its clock cycles per section of the stage loop
    (assemble, factor, solve, gains, value); see `profile_sweep.py`.
    """
    prepared = prepare_sweep(fx, fu, lx, lu, lxx, lux, luu, cx, cu, sec,
                             c_rel, il, iu, phi, zl, zu, lTx, lTxx, mu,
                             nx=nx, nu=nu, nc=nc, inertia=inertia)
    return sweep_prepared(prepared, reg, delta_c, refine=refine, rtol=rtol,
                          atol=atol, profile=profile)
