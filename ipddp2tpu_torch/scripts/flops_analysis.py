"""Floating-point operations of one solver iteration (PyTorch port).

Counterpart of `scripts/flops_analysis.py`: the count that a roofline of
the whole iteration divides by. It counts one iteration (`solve._body`, as
`solve.iteration` runs it) of batched concar from its initialized state, in
the JAX script's two settings: float32 with the backtracking search
(`ls_speculative=0`) and float64 with the speculative search
(`ls_speculative=8`). The instances are drawn by `concar.random_instances`
from `torch.Generator().manual_seed(0)`.

How it counts. A `TorchDispatchMode` sees every aten operation the
iteration dispatches and prices it from its shapes. The iteration runs the
plain versions (`backward_kernel="torch"`, `forward_kernel="torch"`), which
have the kernels' layout and operation order: a kernel is a `ctypes`
launch, which no dispatch mode sees (as the JAX script counts the XLA path,
"which executes the same math as the Pallas kernels"). The rollout is run
eagerly (`graphs.ENABLED = False`: a replayed CUDA graph hides its
operations), and the costate scan in the sequential order, the one the
card runs.

The count covers the whole iteration: every stage of every loop and every
line-search trial that this state's search takes. XLA's HLO cost analysis,
which the JAX script reads, counts the body of a `while` / `scan` once: its
figure leaves out the other T - 1 stages of each scan and all trials but
one, so it is not the work that was done and cannot be set beside this one.

Rules, per aten operation (the sets below name every operation each rule
covers):
- products (mm, bmm, addmm, baddbmm, mv, dot): 2mnk, the formulas of
  `torch.utils.flop_counter` (the addition of addmm / baddbmm is not
  counted); a triangular solve of an n x n factor against k columns: n^2 k
  a matrix of the batch;
- arithmetic elementwise (add, mul, div, min / max, clamp, abs, ...): one
  per output element;
- transcendentals (sin, cos, exp, log, sqrt, tanh, pow, ...): one per
  output element, also totalled apart;
- reductions (sum, mean, amax, amin, prod): input elements less output
  elements; a scatter-reduce: one per source element; a scan (cumsum,
  cumprod): n - 1 along each line of n;
- copies, views, indexing, creation, casts, selects (`where`) and
  comparisons (with boolean logic, `any` / `all`, argmax): zero;
- arithmetic whose output is not floating point (index and counter
  bookkeeping): zero.
Every aten operation that no rule names is reported with its call count as
`uncounted`; none is dropped silently.

Usage:
    python3 -m ipddp2tpu_torch.scripts.flops_analysis [batch ...]
        [--device cuda|cpu]

Prints the JAX script's line for each batch (default 1 and 64) and type,

    b=1 f32 (ls_spec=0): 1.234e+07 flops/batch-iter = 1.234e+07 per instance-iter

then the transcendentals, the pieces, the line-search trials and the
uncounted operations.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import sys
from collections import Counter, defaultdict

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from .. import graphs
from ..models import concar
from ..options import Options
from ..problem import Bounds
from ..solve import initialize, iteration, resolve_device

BATCHES = (1, 64)
# the JAX script's settings: (name, dtype, ls_speculative)
SETTINGS = (("f32", torch.float32, 0), ("f64", torch.float64, 8))
SPECULATIVE = {dtype: spec for _, dtype, spec in SETTINGS}
SEED = 0

PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot",
            "linalg_solve_triangular"}
ARITHMETIC = {"add", "sub", "rsub", "mul", "div", "neg", "abs",
              "reciprocal", "maximum", "minimum", "clamp", "clamp_min",
              "clamp_max", "remainder", "fmod", "square", "sign"}
TRANSCENDENTAL = {"sin", "cos", "tan", "exp", "expm1", "log", "log1p",
                  "log2", "sqrt", "rsqrt", "tanh", "sigmoid", "atan",
                  "atan2", "asin", "acos", "sinh", "cosh", "pow"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "prod"}
SCATTER_REDUCTIONS = {"scatter_reduce"}
SCANS = {"cumsum", "cumprod"}
FREE = {
    # copies, casts and creation
    "_to_copy", "to", "clone", "copy_", "contiguous", "cat", "stack",
    "repeat", "repeat_interleave", "flip", "fill_", "zero_", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "empty",
    "empty_like", "new_empty", "new_full", "new_zeros", "new_ones",
    "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
    "_efficientzerotensor", "_new_zeros_with_same_feature_meta",
    "_local_scalar_dense", "detach", "alias", "tril", "triu",
    "diag_embed", "constant_pad_nd",
    # views
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "squeeze_", "unsqueeze", "unsqueeze_", "select",
    "slice", "diagonal", "split", "split_with_sizes", "unbind", "narrow",
    "as_strided", "unfold",
    # indexing, scatter of copies, the backward of an index (a copy into
    # zeros)
    "index", "index_select", "gather", "scatter", "scatter_",
    "index_put", "index_put_", "masked_fill", "masked_fill_",
    "select_backward", "slice_backward", "diagonal_backward",
    # selects, comparisons and boolean logic
    "where", "eq", "ne", "lt", "le", "gt", "ge", "isfinite", "isnan",
    "isinf", "logical_and", "logical_or", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_not", "bitwise_xor", "any", "all", "argmax",
    "argmin",
}
# the pieces of an iteration whose operations are attributed apart:
# (module, name) -> piece; the rest is "bookkeeping" (KKT errors, the
# regularization ladder, the acceptance tests, the filter)
PIECES = {
    ("ipddp2tpu_torch.solve", "evaluate_derivatives"): "derivatives",
    ("ipddp2tpu_torch.solve", "costate_scan"): "costate scan",
    ("ipddp2tpu_torch.solve", "contract_dynamics_hessian"): "contraction",
    ("ipddp2tpu_torch.backward", "_run_pass"): "backward sweep",
    ("ipddp2tpu_torch.forward", "rollout"): "forward trial",
    ("ipddp2tpu_torch.forward", "_measures"): "trial measures",
}
OTHER = "bookkeeping"
COSTATE_ORDER = "seq"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _tensors(item)


def _shape(a):
    return tuple(a.shape)


def op_cost(func, args, kwargs, out):
    """(flops, transcendentals, rule) of one aten operation; rule None if
    no rule names it."""
    name = func.overloadpacket.__name__
    outs = list(_tensors(out))
    floating = bool(outs) and outs[0].is_floating_point()
    if name in FREE:
        return 0, 0, "zero"
    if name in PRODUCTS:
        if name == "mm":
            f = flop_counter.mm_flop(_shape(args[0]), _shape(args[1]))
        elif name == "bmm":
            f = flop_counter.bmm_flop(_shape(args[0]), _shape(args[1]))
        elif name == "addmm":
            f = flop_counter.addmm_flop(*(_shape(a) for a in args[:3]))
        elif name == "baddbmm":
            f = flop_counter.baddbmm_flop(*(_shape(a) for a in args[:3]))
        elif name == "mv":
            f = 2 * args[0].numel()
        elif name == "dot":
            f = 2 * args[0].numel()
        else:                               # linalg_solve_triangular(A, B)
            A, Bm = args[0], args[1]
            n = A.shape[-1]
            f = (Bm.numel() // n) * n * n
        return int(f), 0, "products"
    if name in ARITHMETIC:
        return (outs[0].numel() if floating else 0), 0, "arithmetic"
    if name in TRANSCENDENTAL:
        n = outs[0].numel() if floating else 0
        return n, n, "transcendental"
    if name in REDUCTIONS:
        if not floating:
            return 0, 0, "reduction"
        return args[0].numel() - outs[0].numel(), 0, "reduction"
    if name in SCATTER_REDUCTIONS:              # scatter_reduce(self, dim, index, src)
        return (args[3].numel() if floating else 0), 0, "scatter-reduction"
    if name in SCANS:                           # cumsum(self, dim): n - 1 a line
        if not floating or not outs[0].numel():
            return 0, 0, "scan"
        n = outs[0].shape[args[1]] if outs[0].dim() else 1
        return outs[0].numel() - outs[0].numel() // n, 0, "scan"
    return 0, 0, None


class FlopCounter(TorchDispatchMode):
    """Counts the aten operations dispatched while it is entered:
    flops and transcendentals by piece (the innermost entered piece of
    `piece`), per call of each piece, and the operations no rule names."""

    def __init__(self):
        super().__init__()
        self.stack = []
        self.flops = Counter()
        self.transcendentals = Counter()
        self.calls = defaultdict(list)      # piece -> flops of each call
        self.uncounted = Counter()
        self.by_rule = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        f, tr, rule = op_cost(func, args, kwargs, out)
        if rule is None:
            self.uncounted[str(func)] += 1
        else:
            self.by_rule[rule] += f
        piece = self.stack[-1][0] if self.stack else OTHER
        self.flops[piece] += f
        self.transcendentals[piece] += tr
        if self.stack:
            self.stack[-1][1] += f
        return out

    def piece(self, name, fn):
        """`fn` wrapped so that what it dispatches counts to `name`."""
        def call(*args, **kwargs):
            self.stack.append([name, 0])
            try:
                return fn(*args, **kwargs)
            finally:
                _, f = self.stack.pop()
                self.calls[name].append(f)
        return call


def concar_state(batch, dtype, device, T=None, identical=False):
    """(problem, bounds, theta, initialized state, options) of `batch`
    concar instances from `torch.Generator().manual_seed(SEED)` (with
    `identical`, the first one `batch` times) at horizon `T` (default
    concar's 100), in `dtype` on `device`, under the JAX script's options
    for that type and the plain versions."""
    T = concar.T if T is None else T
    gen = torch.Generator().manual_seed(SEED)
    theta, f_lim, tau_lim, x1 = concar.random_instances(
        1 if identical else batch, gen)
    if identical:
        rep = lambda a: a.expand((batch,) + a.shape[1:]).clone()
        theta = concar.Theta(rep(theta.obstacles))
        f_lim, tau_lim, x1 = rep(f_lim), rep(tau_lim), rep(x1)
    bounds = concar.bounds(f_lim, tau_lim)
    to = lambda a: a[:, :T].to(dtype=dtype, device=device)
    bounds = Bounds(to(bounds.lower), to(bounds.upper))
    u0 = to(concar.initial_controls().expand(batch, concar.T, concar.NU))
    theta = concar.Theta(theta.obstacles.to(dtype=dtype, device=device))
    x1 = x1.to(dtype=dtype, device=device)
    problem = dataclasses.replace(concar.problem(), T=T)
    options = Options(optimality_tolerance=1e-7, backward_kernel="torch",
                      forward_kernel="torch", auto_tune=False,
                      ls_speculative=SPECULATIVE[dtype])
    state = initialize(problem, theta, bounds, x1, u0, options,
                       device=device)
    return problem, bounds, theta, state, options


def count(batch, dtype, device="cpu", T=None, identical=False):
    """The operations of one iteration of `batch` concar instances (see
    `concar_state`) on `device` (the default GPU raises without one):
    dict(flops, transcendentals, by_piece {piece: dict(flops,
    transcendentals, calls [flops of each call])}, by_rule, trials (the
    rollouts of the line search), uncounted {aten op: calls})."""
    device = resolve_device(device)
    problem, bounds, theta, state, options = concar_state(
        batch, dtype, device, T, identical)
    counter = FlopCounter()
    saved = {}
    for (mod_name, attr), piece in PIECES.items():
        module = importlib.import_module(mod_name)
        saved[(module, attr)] = fn = getattr(module, attr)
        if piece == "costate scan":
            fn = (lambda f: lambda deriv, phi, mode="auto": f(
                deriv, phi, mode=COSTATE_ORDER))(fn)
        setattr(module, attr, counter.piece(piece, fn))
    enabled, graphs.ENABLED = graphs.ENABLED, False
    try:
        with counter:
            iteration(problem, bounds, state, theta, options, device=device)
    finally:
        graphs.ENABLED = enabled
        for (module, attr), fn in saved.items():
            setattr(module, attr, fn)
    pieces = list(PIECES.values()) + [OTHER]
    return dict(
        batch=batch, dtype=str(dtype).replace("torch.", ""), T=problem.T,
        ls_speculative=options.ls_speculative,
        flops=sum(counter.flops.values()),
        transcendentals=sum(counter.transcendentals.values()),
        by_piece={p: dict(flops=counter.flops[p],
                          transcendentals=counter.transcendentals[p],
                          calls=counter.calls.get(p, []))
                  for p in pieces},
        by_rule=dict(counter.by_rule),
        trials=len(counter.calls.get("forward trial", [])),
        uncounted=dict(counter.uncounted))


def report(c):
    """The JAX script's line, then the count's other lines."""
    b, f = c["batch"], c["flops"]
    name = {"float32": "f32", "float64": "f64"}[c["dtype"]]
    lines = [f"b={b} {name} (ls_spec={c['ls_speculative']}): "
             f"{f:.3e} flops/batch-iter = {f / b:.3e} per instance-iter",
             f"    transcendentals {c['transcendentals']:.3e}, "
             f"line-search rollouts {c['trials']}"]
    for piece, p in c["by_piece"].items():
        lines.append(f"    {piece:16s} {p['flops']:.3e} flops in "
                     f"{len(p['calls']) or '-'} call(s)")
    for op, n in sorted(c["uncounted"].items()):
        lines.append(f"    uncounted {op}: {n} call(s)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", nargs="*", type=int, default=list(BATCHES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for batch in args.batches:
        for _, dtype, _ in SETTINGS:
            print("\n".join(report(count(batch, dtype, device))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
