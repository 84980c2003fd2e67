"""The forward-pass CUDA kernels: build, binding, wrappers, plain versions.

`forward_metrics_cuda` evaluates, in ONE launch, the line search's measures
for all K candidate step sizes of every instance; `forward_trial_cuda` rolls
out one step size per instance and returns the trial (`csrc/forward_pass.cu`).
They replace the TPU kernels
`ipddp2tpu/ops/forward_pallas.py::forward_metrics_pallas` and
`::forward_trial_pallas` and keep their signatures without `dd_mode`,
`tile_b`, `interpret`: float64 runs in native FP64, not in double-single
pairs. The model runs inside the kernels, so the problem must name its
device functions (`Problem.device_model`, a header under `csrc/models/`).

Beside each kernel stands its plain PyTorch version, `forward_metrics_plain`
and `forward_trial_plain`: the same walk over the stages in the same order,
with the problem's Python functions. A wrapper takes the plain version only
for tensors that lie on the CPU. For CUDA tensors it launches the kernel or
raises; there is no fallback, not on a failed build either.

Bound on this card: bytes (each instance reads 248 values per stage once;
the arithmetic is far below the vector rate), and in the way of it the
instructions one lane runs per stage. Both kernels deal the rows of the
update law over lanes. The trial kernel: a group of 16 lanes of a warp owns
an instance, its loads cover whole runs of an instance's stage, each lane
loads its rows of stage t+1 before stage t's model runs, and every value is
stored by the lane that holds it. The metrics kernel: a warp owns an
instance and all K of its candidates, which share one copy of each stage in
shared memory, brought in by asynchronous copies one stage ahead; a
candidate is owned by the largest power of two of lanes <= 32 / K (chunks
of 32 candidates above K = 32), its 3 nu + nc rows dealt over those lanes.
`metrics_geometry` computes that layout here in Python; the wrapper passes
it to the library, which refuses a launch with another one, and checks it
against the library's own at load. See the source's header. Both take the
solver's dense tensors: nothing is re-laid out in the wrappers (a tensor
whose base is not 16-byte aligned is copied, as the asynchronous copies
need it).

Build: one library per (device model, nx, nu, nc, complementarity rows),
under `ops/_build/` at first use, by `ops/build.py`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from . import build as _build
from .build import SMEM_LIMIT, dense
from ..derivatives import batched_stage, batched_terminal_cost
from ..problem import Problem

SOURCE = _build.CSRC / "forward_pass.cu"
MODELS = _build.CSRC / "models"

# launches made by the wrappers, per kernel name
launch_counts = {"forward_metrics_f32": 0, "forward_metrics_f64": 0,
                 "forward_trial_f32": 0, "forward_trial_f64": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_libs = {}
_N_PTRS = 34
# the stage-indexed inputs after (lo, hi), in the kernels' order
_STAGE_INPUTS = ("xbar", "ubar", "phibar", "zlbar", "zubar", "ilbar", "iubar")


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


class MetricsGeometry(NamedTuple):
    """How the metrics kernel lays K candidates over the card."""

    lanes: int                  # lanes of a warp that own one candidate
    chunks: int                 # passes over the stages, 32 / lanes each
    instances_per_block: int    # one warp each
    threads: int                # per block
    smem_bytes: int             # per block


def _metrics_instance_values(nx: int, nu: int, nc: int, theta_dim: int,
                             itemsize: int) -> int:
    """Values of shared memory per instance: the layout `MLay<T>` of the
    source (two stage buffers, then theta)."""
    a = 16 // itemsize
    up = lambda n: -(-n // a) * a
    nr = 3 * nu + nc
    lo = up(up(2 * nr) + nr * nx)           # after bar, ff, fb
    stage = up(up(lo + 4 * nu) + nx)        # lo, hi, ilbar, iubar, xbar
    return up(2 * stage + theta_dim)


def metrics_geometry(nx: int, nu: int, nc: int, K: int, dtype,
                     theta_dim: int = 0) -> MetricsGeometry:
    """Lanes per candidate (the largest power of two <= 32 / K, at least 1),
    chunks of candidates, instances, threads and shared bytes per block of
    the metrics kernel. A block is 4 warps where its shared memory fits the
    card's 227 KB, else 2, else 1. Raises ValueError for K < 1 and for a
    model whose one instance does not fit, TypeError for other dtypes."""
    itemsize = {torch.float32: 4, torch.float64: 8}.get(dtype)
    if itemsize is None:
        raise TypeError(f"forward metrics kernel: unsupported dtype {dtype}")
    if K < 1:
        raise ValueError(f"forward metrics kernel: K = {K} candidates")
    lanes = 1 << max(32 // K, 1).bit_length() - 1
    per_chunk = 32 // lanes
    per_instance = _metrics_instance_values(nx, nu, nc, theta_dim,
                                            itemsize) * itemsize
    for warps in (4, 2, 1):
        if warps * per_instance <= SMEM_LIMIT:
            return MetricsGeometry(lanes, -(-K // per_chunk), warps,
                                   32 * warps, warps * per_instance)
    raise ValueError(
        f"forward metrics kernel: nx={nx}, nu={nu}, nc={nc} needs "
        f"{per_instance} bytes of shared memory for one instance, the card "
        f"has {SMEM_LIMIT} (227 KB) a block")


def _model_header(problem: Problem):
    if problem.device_model is None:
        raise ValueError(
            "the forward kernels run the model inside: this problem names "
            "no device functions (Problem.device_model)")
    header = MODELS / f"{problem.device_model}.cuh"
    if not header.exists():
        raise ValueError(f"no device functions {header.name} under "
                         f"{MODELS}")
    return header


def _compl_mask(problem: Problem) -> int:
    return sum(1 << i for i in problem.compl_indices)


def _key(problem: Problem):
    return (problem.device_model, problem.nx, problem.nu, problem.nc,
            _compl_mask(problem))


def start_build(problem: Problem, verbose: bool = False):
    """Start `nvcc` for this problem's library without waiting."""
    header = _model_header(problem)
    model, nx, nu, nc, mask = _key(problem)
    return _build.start(
        f"forward_pass_{model}_nx{nx}_nu{nu}_nc{nc}_m{mask}", SOURCE,
        defines=(f"NX={nx}", f"NU={nu}", f"NC={nc}", f"COMPL_MASK={mask}",
                 f'MODEL_HEADER="models/{header.name}"'),
        depends=(*sorted(MODELS.glob("*.cuh")),     # a header may include
                 _build.CSRC / "scalar_math.cuh",      # another's
                 _build.CSRC / "async_copy.cuh"), verbose=verbose)


def build(problems, verbose: bool = False):
    """Build the libraries of several problems, all `nvcc` processes started
    together. Raises on any failure."""
    return _build.finish_all([start_build(p, verbose=verbose)
                              for p in problems], verbose=verbose)


class _Library:
    def __init__(self, problem: Problem):
        path, = build([problem])
        lib = ctypes.CDLL(str(path))
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        for sfx in _SUFFIX.values():
            m = getattr(lib, f"forward_metrics_{sfx}")
            m.restype = ctypes.c_int
            m.argtypes = [ptrs, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ints, ctypes.c_void_p]
            t = getattr(lib, f"forward_trial_{sfx}")
            t.restype = ctypes.c_int
            t.argtypes = [ptrs, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.forward_dims.restype = ctypes.c_int
        lib.forward_dims.argtypes = [ctypes.POINTER(ctypes.c_int)]
        dims = (ctypes.c_int * 5)()
        lib.forward_dims(dims)
        want = [problem.nx, problem.nu, problem.nc]
        if list(dims[:3]) != want or dims[4] != _compl_mask(problem):
            raise RuntimeError(f"{path.name} was built for {list(dims)}, "
                               f"the problem has {want}")
        self.lib = lib
        self.theta_dim = int(dims[3])
        self._check_geometry(problem, path.name)

    def _check_geometry(self, problem: Problem, name: str):
        """The metrics geometry computed here against the library's own,
        for every K up to 64 in both types."""
        fn = self.lib.forward_metrics_geometry
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        got = (ctypes.c_int * 5)()
        for dtype, itemsize in ((torch.float32, 4), (torch.float64, 8)):
            for K in range(1, 65):
                want = metrics_geometry(problem.nx, problem.nu, problem.nc,
                                        K, dtype, self.theta_dim)
                if fn(K, itemsize, got) != 0 or list(got) != list(want):
                    raise RuntimeError(
                        f"{name}: metrics geometry at K={K}, {dtype} is "
                        f"{list(got)}, the wrapper computed {list(want)}")


def _library(problem: Problem) -> _Library:
    key = _key(problem)
    lib = _libs.get(key)
    if lib is None:
        lib = _libs[key] = _Library(problem)
    return lib


def _flat_theta(theta, B: int, dtype, device, width: int):
    """The theta leaves, in the order of the pytree, as one dense
    `[B, width]` tensor; None where the model takes no parameters."""
    leaves = [] if theta is None else pytree.tree_leaves(theta)
    for leaf in leaves:
        if leaf.shape[0] != B or leaf.dtype != dtype or leaf.device != device:
            raise ValueError(
                f"theta leaf {tuple(leaf.shape)} {leaf.dtype} on "
                f"{leaf.device}: expected [{B}, ...] {dtype} on {device}")
    if not leaves:
        flat = None
    elif len(leaves) == 1:              # a view where the leaf is dense
        flat = leaves[0].reshape(B, -1)
    else:
        flat = torch.cat([leaf.reshape(B, -1) for leaf in leaves], dim=1)
    got = 0 if flat is None else flat.shape[1]
    if got != width:
        raise ValueError(f"theta has {got} values per instance, the "
                         f"model's device functions take {width}")
    return None if flat is None else flat.contiguous()


def _checked(problem: Problem, lo, hi, gains, stage_inputs, mu, tau, gamma,
             gamma_shape):
    """Shapes, dtype and device of everything the kernels read; returns the
    named tensors in the kernels' order."""
    ubar = stage_inputs[1]
    B, T = ubar.shape[0], problem.T
    nx, nu, nc = problem.nx, problem.nu, problem.nc
    dtype, device = ubar.dtype, ubar.device
    row = {"nu": (B, T, nu), "nc": (B, T, nc)}
    want = dict(
        lo=row["nu"], hi=row["nu"], xbar=(B, T + 1, nx), ubar=row["nu"],
        phibar=row["nc"], zlbar=row["nu"], zubar=row["nu"], ilbar=row["nu"],
        iubar=row["nu"], alpha=row["nu"], beta=(B, T, nu, nx),
        psi=row["nc"], omega=(B, T, nc, nx), chi_l=row["nu"],
        zeta_l=(B, T, nu, nx), chi_u=row["nu"], zeta_u=(B, T, nu, nx),
        mu=(B,), tau=(B,), gamma=gamma_shape(B))
    names = ("alpha", "beta", "psi", "omega", "chi_l", "zeta_l", "chi_u",
             "zeta_u")
    named = dict(lo=lo, hi=hi, **dict(zip(_STAGE_INPUTS, stage_inputs)),
                 **dict(zip(names, gains)), mu=mu, tau=tau, gamma=gamma)
    for name, shape in want.items():
        a = named[name]
        if shape is not None and tuple(a.shape) != shape:
            raise ValueError(
                f"{name}: shape {tuple(a.shape)}, expected {shape}")
        if a.dtype != dtype or a.device != device:
            raise ValueError(f"{name}: {a.dtype} on {a.device}, expected "
                             f"{dtype} on {device}")
    return named, B, dtype, device


def _walk(problem: Problem, theta, lo, hi, gains, xbar, ubar, phibar, zlbar,
          zubar, ilbar, iubar, mu, tau, gamma, emit: bool):
    """The kernels' rollout in plain PyTorch for N lanes at step sizes
    `gamma [N]`: the stages in the kernels' order, theta, J and L summed
    stage by stage. `emit` returns the trial, else the measures."""
    T, nu, nc = problem.T, problem.nu, problem.nc
    stage = batched_stage(problem)
    alpha, beta, psi, omega, chi_l, zeta_l, chi_u, zeta_u = gains
    # the four update laws share (x - x_bar): their rows are stacked
    # u (nu) | phi (nc) | zl (nu) | zu (nu)
    ff = (torch.cat([ubar, phibar, zlbar, zubar], dim=-1)
          + gamma[:, None, None] * torch.cat([alpha, psi, chi_l, chi_u],
                                             dim=-1))
    fb = torch.cat([beta, omega, zeta_l, zeta_u], dim=-2)    # [N, T, R, nx]
    x = xbar[:, 0]
    if emit:
        xs, rows, cs = [x], [], []
    else:
        ml, mu_m = torch.isfinite(lo), torch.isfinite(hi)
        s = (1.0 - tau)[:, None]
        one, zero = torch.ones_like(lo[:, 0]), torch.zeros_like(lo[:, 0])
        mask = problem.compl_mask(mu.dtype, mu.device)
        th, L, J = (torch.zeros_like(mu) for _ in range(3))
        fin = torch.ones_like(mu, dtype=torch.bool)
        ftb = fin.clone()
    for t in range(T):
        dx = x - xbar[:, t]
        row = ff[:, t] + (fb[:, t] @ dx[..., None])[..., 0]
        u, phi, zl, zu = torch.split(row, [nu, nc, nu, nu], dim=-1)
        x_next, c, cost = stage(x, u, t, theta)
        if emit:
            xs.append(x_next)
            rows.append(row)
            cs.append(c)
        else:
            il, iu = u - lo[:, t], hi[:, t] - u
            fin = (fin & torch.isfinite(row).all(dim=1)
                   & torch.isfinite(x_next).all(dim=1)
                   & torch.isfinite(c).all(dim=1))
            ftb = ftb & ~((s * ilbar[:, t] > il).any(dim=1)
                          | (s * iubar[:, t] > iu).any(dim=1)
                          | (s * zlbar[:, t] > zl).any(dim=1)
                          | (s * zubar[:, t] > zu).any(dim=1))
            c_rel = c - mu[:, None] * mask if problem.compl_indices else c
            logs = (torch.where(ml[:, t], torch.log(
                        torch.where(ml[:, t], il, one)), zero).sum(dim=1)
                    + torch.where(mu_m[:, t], torch.log(
                        torch.where(mu_m[:, t], iu, one)), zero).sum(dim=1))
            th = th + c_rel.abs().sum(dim=1)
            J = J + cost
            L = L + (cost + ((c_rel * phi).sum(dim=1) - mu * logs))
        x = x_next
    if emit:
        rows = torch.stack(rows, dim=1)
        u, phi, zl, zu = torch.split(rows, [nu, nc, nu, nu], dim=-1)
        return (torch.stack(xs, dim=1), u, phi, zl, zu, u - lo, hi - u,
                torch.stack(cs, dim=1))
    term = batched_terminal_cost(problem)(x, theta)
    return th, L + term, J + term, fin, ftb


def forward_metrics_plain(problem: Problem, theta, lo, hi, gains,
                          xbar, ubar, phibar, zlbar, zubar, ilbar, iubar,
                          mu, tau, gammas):
    """Plain version of `forward_metrics_cuda`: the K candidates of every
    instance become B*K lanes of one walk."""
    B, K = ubar.shape[0], gammas.shape[0]
    rep = lambda a: a.repeat_interleave(K, dim=0)
    theta_k = None if theta is None else pytree.tree_map(rep, theta)
    out = _walk(problem, theta_k, rep(lo), rep(hi),
                tuple(rep(g) for g in gains), rep(xbar), rep(ubar),
                rep(phibar), rep(zlbar), rep(zubar), rep(ilbar), rep(iubar),
                rep(mu), rep(tau), gammas.repeat(B), emit=False)
    return tuple(a.reshape(B, K) for a in out)


def forward_trial_plain(problem: Problem, theta, lo, hi, gains,
                        xbar, ubar, phibar, zlbar, zubar, ilbar, iubar,
                        mu, tau, gamma):
    """Plain version of `forward_trial_cuda`."""
    return _walk(problem, theta, lo, hi, gains, xbar, ubar, phibar, zlbar,
                 zubar, ilbar, iubar, mu, tau, gamma, emit=True)


def _launch(kind: str, problem: Problem, theta, named, B, dtype, device,
            outputs, n_before, K=None):
    """Launch `forward_<kind>_<dtype>` with the named inputs and the output
    tensors placed after `n_before` null pointers; the metrics kernel gets
    K and its geometry."""
    if device.type != "cuda":
        raise RuntimeError(f"forward_{kind}_cuda: unsupported device "
                           f"{device}")
    sfx = _SUFFIX.get(dtype)
    if sfx is None:
        raise TypeError(f"forward_{kind}_cuda: unsupported dtype {dtype}")
    library = _library(problem)
    theta_flat = _flat_theta(theta, B, dtype, device, library.theta_dim)
    # the kernels read dense row-major tensors starting on 16 bytes; the
    # packed copies are dropped when this function returns, before the
    # kernel has run: the caching allocator hands their memory only to later
    # work on this stream
    order = ("lo", "hi") + _STAGE_INPUTS + (
        "alpha", "beta", "psi", "omega", "chi_l", "zeta_l", "chi_u",
        "zeta_u")
    ins = [dense(named[k]) for k in order]
    tail = [named[k].contiguous() for k in ("mu", "tau", "gamma")]
    addr = ([t.data_ptr() for t in ins]
            + [None if theta_flat is None else theta_flat.data_ptr()]
            + [t.data_ptr() for t in tail])
    outs = [None] * (_N_PTRS - len(addr))
    outs[n_before:n_before + len(outputs)] = [t.data_ptr() for t in outputs]
    ptrs = (ctypes.c_void_p * _N_PTRS)(*addr, *outs)
    name = f"forward_{kind}_{sfx}"
    extra = ()
    if K is not None:
        geo = metrics_geometry(problem.nx, problem.nu, problem.nc, K, dtype,
                               library.theta_dim)
        extra = (K, (ctypes.c_int * 5)(*geo))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(library.lib, name)(ptrs, B, problem.T, *extra,
                                         ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{name}: launch refused, CUDA error {err} (B={B}, "
            f"T={problem.T}, model={problem.device_model})")
    launch_counts[name] += 1


def forward_metrics_cuda(problem: Problem, theta, lo, hi, gains,
                         xbar, ubar, phibar, zlbar, zubar, ilbar, iubar,
                         mu, tau, gammas):
    """Line-search measures of all K candidate step sizes in one launch.

    Inputs are batch-leading (`[B, T, ...]`, `xbar [B, T+1, nx]`), `mu` and
    `tau` are `[B]`, `gammas` is `[K]`; `theta` is the problem's parameter
    pytree with `[B, ...]` leaves, or None. Returns
    (theta_sum, L, J, finite, ftb_ok), each `[B, K]`, the last two bool.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    stage_inputs = (xbar, ubar, phibar, zlbar, zubar, ilbar, iubar)
    named, B, dtype, device = _checked(
        problem, lo, hi, gains, stage_inputs, mu, tau, gammas,
        lambda B: None)
    if gammas.dim() != 1:
        raise ValueError(f"gammas: shape {tuple(gammas.shape)}, expected [K]")
    if device.type == "cpu":
        return forward_metrics_plain(problem, theta, lo, hi, gains,
                                     *stage_inputs, mu, tau, gammas)
    K = gammas.shape[0]
    new = lambda dt: torch.empty((B, K), dtype=dt, device=device)
    outs = (new(dtype), new(dtype), new(dtype), new(torch.bool),
            new(torch.bool))
    if K > 0:
        _launch("metrics", problem, theta, named, B, dtype, device, outs, 0,
                K=K)
    return outs


def forward_trial_cuda(problem: Problem, theta, lo, hi, gains,
                       xbar, ubar, phibar, zlbar, zubar, ilbar, iubar,
                       mu, tau, gamma):
    """Roll out ONE step size per instance, `gamma [B]`, and return the
    trial: (x [B,T+1,nx], u, phi, zl, zu, il, iu, c_raw), with c_raw the
    un-relaxed constraint values (what `forward.rollout` returns). The
    nominal slacks, `mu` and `tau` belong to the shared signature; the
    trial does not depend on them.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    stage_inputs = (xbar, ubar, phibar, zlbar, zubar, ilbar, iubar)
    named, B, dtype, device = _checked(
        problem, lo, hi, gains, stage_inputs, mu, tau, gamma,
        lambda B: (B,))
    if device.type == "cpu":
        return forward_trial_plain(problem, theta, lo, hi, gains,
                                   *stage_inputs, mu, tau, gamma)
    T, nx, nu, nc = problem.T, problem.nx, problem.nu, problem.nc
    new = lambda *shape: torch.empty((B,) + shape, dtype=dtype,
                                     device=device)
    x = new(T + 1, nx)
    u, phi, zl, zu, il, iu, c = (new(T, nu), new(T, nc), new(T, nu),
                                 new(T, nu), new(T, nu), new(T, nu),
                                 new(T, nc))
    _launch("trial", problem, theta, named, B, dtype, device,
            (x, u, phi, zl, zu, il, iu, c), 5)
    return x, u, phi, zl, zu, il, iu, c
