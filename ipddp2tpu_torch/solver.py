"""Reference-parity facade (PyTorch port).

Counterpart of `ipddp2tpu/solver.py`: the reference's exported construction
API (reference: src/InteriorPointDDP.jl:29-45: Objective, Constraint,
Dynamics, Bound, Solver, Options, solve!, get_trajectory) on top of the
functional core. The reference builds per-stage lists where the last stage
has `num_control = 0` and carries the terminal objective (reference:
src/data/problem.jl:39-78); this facade accepts the same shape of input and
lowers it to the uniform-stage `Problem` with an explicit terminal cost:
ragged per-stage control and constraint dimensions by padding (extra
controls carry a tiny quadratic cost, each padded constraint row pins one of
them to zero), ragged state dimensions by zero state slots.

The user callables take (x, u) on one instance's 1-D tensors and must trace
under `torch.func` like a model's stage functions (`problem.py`); they are
wrapped into the port's (x, u, t, theta) stage functions. A time-varying
stage list becomes one function that evaluates each distinct callable and
selects by the stage index with `torch.where` (what a vmapped `lax.switch`
does in the JAX package): the port maps the stage functions over time with
`torch.func.vmap`, where the stage index is a batched tensor that no Python
branch can read. A rollout calls them with the stage as a Python int and
takes the one branch. A uniform list stays one direct call.

Limit: a facade problem names no `device_model` (no hand-written kernel can
run a user's Python callable), so its line search takes the plain rollout,
replayed from a CUDA graph on a GPU, whatever `forward_kernel` says under
"auto" (and "cuda" raises). Its backward sweep is the LDL^T kernel, K2 in
float64 and K1 in float32, which only reads stage tensors.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .options import Options
from .problem import Bounds, Problem
from .solve import Solution, resolve_device, solve


class Dynamics:
    """Discrete dynamics x' = f(x, u) (reference: src/dynamics.jl:1-42)."""

    def __init__(self, f: Callable, num_state: int, num_control: int):
        self.f = f
        self.num_state = num_state
        self.num_control = num_control


class Objective:
    """Stage cost l(x, u) (reference: src/objectives.jl:1-33).

    A terminal objective is `Objective(f, nx, 0)`; its callable receives a
    zero-length control vector, as in the reference convention."""

    def __init__(self, f: Callable, num_state: int, num_control: int):
        self.f = f
        self.num_state = num_state
        self.num_control = num_control


def _zeros(n: int) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.float64)


class Constraint:
    """Stagewise equality constraint c(x, u) = 0
    (reference: src/constraints.jl:1-58).

    `Constraint(nx, nu)` (no callable) is the empty constraint.
    `indices_compl` marks complementarity rows relaxed by mu
    (reference: src/constraints.jl:16-50); 0-indexed here. Without
    `num_constraint` the callable is called once on float64 zeros on the
    CPU to find it (the JAX package's `jax.eval_shape`); a callable that
    closes over tensors on another device names it."""

    def __init__(self, *args, num_constraint: Optional[int] = None,
                 indices_compl: Sequence[int] = ()):
        if args and callable(args[0]):
            self.f, self.num_state, self.num_control = args[:3]
            if num_constraint is None:
                num_constraint = int(self.f(_zeros(self.num_state),
                                            _zeros(self.num_control))
                                     .shape[0])
            self.num_constraint = num_constraint
        else:
            self.f = None
            self.num_state, self.num_control = args[:2]
            self.num_constraint = 0
        self.indices_compl = tuple(indices_compl)


class Bound:
    """Box bound on controls, +-inf allowed (reference: src/bounds.jl:12-26).

    Bound(lower, upper) | Bound(num_control) unbounded |
    Bound(num_control, lo_scalar, up_scalar)."""

    def __init__(self, *args):
        if len(args) == 1 and isinstance(args[0], int):
            n = args[0]
            self.lower = np.full(n, -np.inf)
            self.upper = np.full(n, np.inf)
        elif len(args) == 3 and isinstance(args[0], int):
            n, lo, hi = args
            self.lower = np.full(n, float(lo))
            self.upper = np.full(n, float(hi))
        else:
            self.lower = np.asarray(args[0], dtype=float)
            self.upper = np.asarray(args[1], dtype=float)


def _lower_stagewise(fns: List[Callable], keys=None):
    """Lower a per-stage list of (x, u)-callables to one (x, u, t, theta)
    function: a direct call when uniform, else every distinct callable
    evaluated and the stage's one selected.

    `keys` gives each stage's dedupe identity (e.g. `(user_fn, nu_t)`):
    callers wrap the user callables in fresh per-stage closures, so wrapper
    identity alone would lower a uniform problem to T branches, every one of
    them evaluated at every stage."""
    if keys is None:
        keys = fns
    unique: List[Callable] = []
    seen: list = []
    index: List[int] = []
    for f, k in zip(fns, keys):
        for i, k2 in enumerate(seen):
            if k2 == k:
                index.append(i)
                break
        else:
            index.append(len(seen))
            seen.append(k)
            unique.append(f)
    if len(unique) == 1:
        f = unique[0]
        return lambda x, u, t, theta: f(x, u)
    tables = {}               # the branch of each stage, per device

    def dispatch(x, u, t, theta):
        if isinstance(t, int):                # a rollout's stage
            return unique[index[t]](x, u)
        table = tables.get(t.device)
        if table is None:
            table = tables[t.device] = torch.tensor(
                index, dtype=torch.int64, device=t.device)
        branch = torch.index_select(table, 0, t.reshape(1))[0]
        out = unique[0](x, u)
        for i, g in enumerate(unique[1:], start=1):
            out = torch.where(branch == i, g(x, u), out)
        return out

    return dispatch


class Solver:
    """Reference-style solver facade (reference: src/solver.jl:4-26).

    dynamics: list of T Dynamics; objectives: list of T+1 Objective (last is
    terminal); constraints: list of T+1 Constraint (last empty); bounds: list
    of T+1 Bound (last empty). `device`: where `solve` runs (default the
    GPU, which raises without one; `device="cpu"` for the plain path)."""

    PAD_COST = 1e-2      # tiny quadratic cost keeping padded controls at 0

    def __init__(self, dynamics: List[Dynamics], objectives: List[Objective],
                 constraints: Optional[List[Constraint]] = None,
                 bounds: Optional[List[Bound]] = None,
                 options: Optional[Options] = None, device=None):
        N = len(objectives)
        T = N - 1
        assert len(dynamics) == T, (
            "length(dynamics) + 1 == length(objectives) "
            "(reference: src/data/problem.jl:41)")
        # Per-stage state dims may vary (reference README.md:19; the
        # reference infers num_next_state by tracing f, src/dynamics.jl:19).
        # Ragged nx is lifted to the uniform [T+1, nx_max] layout by zero
        # padding: padded state slots carry f_pad = 0 dynamics (exactly
        # decoupled — the backward pass never inverts fx, so zero rows/cols
        # are harmless) and every stage fn reads only its true slice.
        nxs = [d.num_state for d in dynamics]
        shape_cache: dict = {}

        def next_dim(d):
            key = (d.f, d.num_state, d.num_control)
            if key not in shape_cache:
                shape_cache[key] = int(d.f(_zeros(d.num_state),
                                           _zeros(d.num_control)).shape[0])
            return shape_cache[key]

        next_nxs = [next_dim(d) for d in dynamics]
        for t in range(T - 1):
            assert next_nxs[t] == nxs[t + 1], (
                f"dynamics[{t}] produces {next_nxs[t]} states but "
                f"dynamics[{t + 1}] consumes {nxs[t + 1]}")
        nxs = nxs + [next_nxs[-1]]          # nxs[t] = state dim entering t
        nx = max(nxs)
        self._nxs = nxs
        self._ragged_nx = len(set(nxs)) > 1

        if constraints is None:
            constraints = [Constraint(nx, d.num_control) for d in dynamics]
            constraints += [Constraint(nx, 0)]
        if bounds is None:
            bounds = [Bound(d.num_control) for d in dynamics] + [Bound(0)]

        stage_cons = constraints[:T]
        nus = [d.num_control for d in dynamics]
        ncs = [c.num_constraint for c in stage_cons]
        # Ragged per-stage control/constraint dims (reference README:19) are
        # lifted to the uniform [T, n] layout by padding: extra controls get a
        # tiny quadratic cost (optimum 0) and each padded constraint row pins
        # one extra control to zero, keeping every stage KKT nonsingular.
        nc_max = max(ncs) if ncs else 0
        nu_max = max(nu_t + (nc_max - nc_t)
                     for nu_t, nc_t in zip(nus, ncs)) if nus else 0
        self._ragged = (len(set(nus)) > 1 or len(set(ncs)) > 1)
        nu, nc = nu_max, nc_max

        compl = stage_cons[0].indices_compl if stage_cons else ()
        assert all(c.indices_compl == compl for c in stage_cons), (
            "complementarity rows must be uniform across stages")

        def pad_stage(f, nu_t, nx_t, nx_n):
            def dyn(x, u):
                y = f(x[:nx_t], u[:nu_t])
                if nx_n < nx:           # padded state slots evolve as 0
                    y = torch.cat([y, x.new_zeros((nx - nx_n,))])
                return y
            return dyn

        dyn_fn = _lower_stagewise(
            [pad_stage(d.f, nu_t, nx_t, nx_n)
             for d, nu_t, nx_t, nx_n in zip(dynamics, nus, nxs, nxs[1:])],
            keys=[(d.f, nu_t, nx_t, nx_n)
                  for d, nu_t, nx_t, nx_n in zip(dynamics, nus, nxs,
                                                 nxs[1:])])

        pad_cost = self.PAD_COST

        def make_cost(f, nu_t, nx_t):
            def cost(x, u):
                pad = u[nu_t:]
                return f(x[:nx_t], u[:nu_t]) + pad_cost * (pad * pad).sum()
            return cost

        cost_fn = _lower_stagewise(
            [make_cost(o.f, nu_t, nx_t)
             for o, nu_t, nx_t in zip(objectives[:T], nus, nxs)],
            keys=[(o.f, nu_t, nx_t)
                  for o, nu_t, nx_t in zip(objectives[:T], nus, nxs)])
        term_f = objectives[T].f
        nx_T = nxs[T]

        if nc_max > 0:
            def make_con(c, nu_t, nc_t, nx_t):
                def con(x, u):
                    rows = (c.f(x[:nx_t], u[:nu_t]) if c.f is not None
                            else x.new_zeros((0,)))
                    # pin the first (nc_max - nc_t) padded controls
                    pins = u[nu_t:nu_t + (nc_max - nc_t)]
                    return torch.cat([rows, pins])
                return con

            con_fn = _lower_stagewise(
                [make_con(c, nu_t, nc_t, nx_t)
                 for c, nu_t, nc_t, nx_t in zip(stage_cons, nus, ncs, nxs)],
                keys=[(c.f, nu_t, nc_t, nx_t)
                      for c, nu_t, nc_t, nx_t in zip(stage_cons, nus, ncs,
                                                     nxs)])
        else:
            con_fn = None

        def pad_bound(values, fill):
            out = np.full(nu_max, fill, dtype=float)
            out[:len(values)] = values
            return out

        self.problem = Problem(
            T=T, nx=nx, nu=nu, nc=nc,
            dynamics=dyn_fn, stage_cost=cost_fn,
            terminal_cost=lambda x, theta: term_f(x[:nx_T],
                                                  x.new_zeros((0,))),
            constraints=con_fn, compl_indices=compl)
        self.bounds = Bounds(
            lower=torch.as_tensor(np.stack(
                [pad_bound(b.lower, -np.inf) for b in bounds[:T]])),
            upper=torch.as_tensor(np.stack(
                [pad_bound(b.upper, np.inf) for b in bounds[:T]])))
        self._nus = nus
        self.options = options or Options()
        self.device = device
        self.solution: Optional[Solution] = None
        self.wall_time: float = 0.0

    def solve(self, x1, u_init) -> Solution:
        """Reference `solve!(solver, x1, u_init)` (reference: src/solve.jl:1-4).

        x1: [nx] (or a ragged first stage's shorter state); u_init: [T, nu]
        array or tensor, or a reference-style list of per-stage vectors (a
        trailing empty terminal entry is ignored). Runs the single instance
        as a batch of one and returns its fields without the batch axis.
        Wall-clock time of the call lands in `self.wall_time`, mirroring the
        reference's SolverData timers (reference: src/solve.jl:86-87)."""
        device = resolve_device(self.device)
        dtype = (x1.dtype if isinstance(x1, torch.Tensor)
                 and x1.is_floating_point() else torch.float64)
        nx, nu, T = self.problem.nx, self.problem.nu, self.problem.T
        if isinstance(u_init, (list, tuple)):
            u_init = [np.asarray(v, dtype=float) for v in u_init]
            if len(u_init) == T + 1 and u_init[-1].size == 0:
                u_init = u_init[:-1]
            u_init = np.stack([np.concatenate([v, np.zeros(nu - v.size)])
                               for v in u_init])
        as_tensor = lambda a: torch.as_tensor(a).to(device=device,
                                                    dtype=dtype)
        x1 = as_tensor(x1)
        if x1.shape[0] < nx:                    # ragged-nx lift (README:19)
            x1 = torch.cat([x1, x1.new_zeros((nx - x1.shape[0],))])
        u_init = as_tensor(u_init)
        bounds = Bounds(as_tensor(self.bounds.lower),
                        as_tensor(self.bounds.upper))
        if self.options.verbose:
            from .utils.printing import solver_banner
            solver_banner()
        t0 = time.time()
        sol = solve(self.problem, bounds, x1[None], u_init[None],
                    options=self.options, device=device)
        converged = bool(sol.converged[0])      # forces completion
        self.wall_time = time.time() - t0
        self.solution = Solution(*(f[0] for f in sol))
        if self.options.verbose:
            from .utils.printing import exit_message
            print(exit_message(int(self.solution.status), converged))
        return self.solution


def get_trajectory(solver: Solver):
    """(states, controls) of the accepted iterate
    (reference: src/solver.jl:46-48). With ragged per-stage state dims the
    states come back as a list of per-stage vectors trimmed to each stage's
    true dimension (the uniform case returns dense [T+1, nx] / [T, nu])."""
    assert solver.solution is not None, "call solver.solve first"
    x, u = solver.solution.x, solver.solution.u
    if getattr(solver, "_ragged_nx", False):
        x = [x[t, :n] for t, n in enumerate(solver._nxs)]
    return x, u


def current_trajectory(solver: Solver):
    """Alias of the accepted iterate (the functional core keeps no separate
    trial copy; reference: src/solver.jl:50-52)."""
    return get_trajectory(solver)
