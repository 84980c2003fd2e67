"""Solver hyperparameters of the PyTorch/CUDA port.

A copy of the JAX package's option set (`ipddp2tpu/options.py`), itself a
mirror of the reference's (reference: src/options.jl:1-38): the same field
names and the same defaults, so a configuration reads the same in both
packages. The port keeps its own copy because it imports nothing of the JAX
package.

What differs is the set of values the kernel-dispatch knobs take on a GPU
(`backward_kernel`, `forward_kernel`: "cuda" where the JAX package says
"pallas"), and that the options the port does not implement yet are refused by `validate` instead of being
silently downgraded.

The dataclass is frozen and hashable: the port caches its `torch.func`
closures and built kernels per (problem, options).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Options:
    quasi_newton: bool = False          # drop all second-order tensor contractions
    optimality_tolerance: float = 1.0e-8
    max_iterations: int = 1000
    reset_cache: bool = True            # unused (parity)
    verbose: bool = False
    print_frequency: int = 10

    mu_init: float = 1.0                # barrier parameter initialisation
    ineq_dual_init: float = 1.0         # unused (parity): bound duals init to 1
    kappa_1: float = 0.01               # interior projection margin (abs)
    kappa_2: float = 0.01               # interior projection margin (rel)

    reg_1: float = 1e-4                 # first primal regularization value
    reg_min: float = 1e-20
    reg_max: float = 1e40
    kappa_w_plus_bar: float = 100.0     # reg bump when no previous reg
    kappa_w_plus: float = 8.0           # reg bump with previous reg
    kappa_w_minus: float = 1.0 / 3.0    # reg warm-start decrease
    kappa_c: float = 0.25               # dual reg exponent: delta_c * mu**kappa_c
    delta_c: float = 1e-8               # dual regularization scale

    kappa_eps: float = 10.0             # barrier decrease trigger: err_mu <= kappa_eps*mu
    kappa_mu: float = 0.2               # linear barrier decrease factor
    theta_mu: float = 1.2               # superlinear barrier decrease exponent
    tau_min: float = 0.99               # fraction-to-boundary lower bound

    s_max: float = 100.0                # scaling threshold for NLP error
    eta_L: float = 1e-4                 # Armijo relaxation factor
    s_L: float = 2.3                    # switching rule: barrier model exponent
    delta: float = 1.0                  # switching rule: constraint violation multiplier
    s_theta: float = 1.1                # switching rule: violation exponent
    gamma_alpha: float = 0.05           # unused (parity)
    gamma_theta: float = 1e-5           # filter margin: constraint violation
    gamma_L: float = 1e-5               # filter margin: barrier Lagrangian

    kappa_Sigma: float = 1e10           # unused (parity): dual rescaling threshold

    # --- extensions shared with the JAX package (not in the reference) ---
    filter_capacity: int = 64           # fixed-capacity ring buffer replaces the
                                        # reference's unbounded push! list
    inertia_atol: float = 1e-12         # |eig| tolerance for zero-eigenvalue count
                                        # (reference: inertia! atol=1e-12)
    max_backward_restarts: int = 60     # hard cap on the reg-ladder loop;
                                        # reference loops until reg > reg_max which
                                        # takes <= ~56 bumps from reg_1 with x8 steps
    refine_steps: int = 1               # iterative refinement sweeps on KKT solves
    backward_mode: str = "scan"         # "scan" (sequential sweep, matches
                                        # the reference); "parallel" (the
                                        # associative-scan Riccati pass,
                                        # parallel/priccati.py); "timeshard"
                                        # (its value scan sharded over a
                                        # time mesh: solve_timesharded)
    backward_kernel: str = "auto"       # batched backward-sweep dispatch:
                                        # "auto"  = the hand-written CUDA
                                        #           sweep kernel of the
                                        #           stage solve ("ldl" or
                                        #           "bk") when the tensors
                                        #           are on a GPU; the plain
                                        #           PyTorch sweep on the
                                        #           CPU and for "eigh"
                                        # "cuda"  = always the CUDA kernel
                                        #           (raises off-GPU, for
                                        #           "eigh", or if the
                                        #           build fails)
                                        # "torch" = always the plain sweep
    ldlt_unroll: bool = True            # unused by the port (parity): the
                                        # JAX package's compile-size knob
    kkt_residual_rtol: float = 1e-6     # backward-stability gate on refined KKT
                                        # solves; failing it triggers the same
                                        # reg-bump escape as wrong inertia
    inertia_method: str = "auto"        # "auto" (the default) resolves per
                                        #   problem at the solve entry
                                        #   points: "bk" when the problem
                                        #   declares mu-relaxed
                                        #   complementarity rows (contact
                                        #   problems — measured: restores
                                        #   exact acrobot golden parity and
                                        #   reference-level 98/100 pushing
                                        #   success), else "ldl";
                                        # "ldl" (fast, diagonal-pivoted +
                                        #   refinement),
                                        # "eigh" (oracle: exact inertia), or
                                        # "bk" (reference-faithful rook
                                        #   Bunch-Kaufman diagnostic,
                                        #   ops/bk.py — LAPACK sytrf_rook's
                                        #   decision structure + the exact
                                        #   reg-ladder semantics of
                                        #   src/inertia_correction.jl)
    ls_min_step: float = 0.0            # extra lower bound on line-search step size
                                        # (0 = machine eps like the reference)
    ls_failure_resets: int = 0          # robustness extension (0 = reference
                                        # behavior): on a line-search failure,
                                        # reset the filter and retry up to this
                                        # many times before declaring status 7
                                        # (rescues near-convergence filter
                                        # saturation on degenerate contact
                                        # problems)
    ls_speculative: int = 0             # 0 = reference backtracking loop;
                                        # K > 0 = evaluate gammas 2^-0..2^-(K-1)
                                        # of every lane at once (one launch
                                        # of the forward-metrics kernel, or
                                        # a [B*K] plain rollout) and pick
                                        # the largest acceptable; alone, a
                                        # lane with none fails (status 7)
    ls_spec_continue: bool = False      # hybrid line search: after the
                                        # ls_speculative candidates, CONTINUE
                                        # sequential backtracking from
                                        # 2^-K instead of failing — semantics
                                        # identical to pure backtracking
                                        # (largest acceptable step), wall =
                                        # one batched K-candidate evaluation
                                        # in the common case; the lockstep
                                        # tail loop only runs for instances
                                        # backtracking below 2^-K
    forward_kernel: str = "auto"        # forward-pass dispatch:
                                        # "auto"  = the hand-written CUDA
                                        #           forward kernels for the
                                        #           speculative / hybrid
                                        #           search when the tensors
                                        #           are on a GPU and the
                                        #           problem names its device
                                        #           functions; the plain
                                        #           (graph-replayed) rollout
                                        #           for pure backtracking
                                        # "cuda"  = always the kernels, the
                                        #           backtracking trials too
                                        #           (raises off-GPU, or for
                                        #           a problem without device
                                        #           functions)
                                        # "torch" = always the plain rollout
                                        # "xla"   = the JAX package's name
                                        #           for its un-fused path:
                                        #           the same as "torch"
    auto_tune: bool = True              # autotune.tune fills knobs still
                                        # at their defaults from its table
                                        # on a GPU; the table is empty (no
                                        # crossover measured on the H100)

    def validate(self) -> "Options":
        """Refuse what the port does not implement yet. Nothing is
        downgraded silently: an option either does what it says or raises."""
        if self.backward_kernel not in ("auto", "cuda", "torch"):
            raise ValueError(
                f"backward_kernel={self.backward_kernel!r}: expected "
                "'auto', 'cuda' or 'torch'")
        if self.forward_kernel not in ("auto", "cuda", "torch", "xla"):
            raise ValueError(
                f"forward_kernel={self.forward_kernel!r}: expected 'auto', "
                "'cuda', 'torch' or 'xla' (the JAX package's Pallas kernels "
                "are the CUDA kernels here: 'cuda')")
        if self.ls_speculative < 0:
            raise ValueError(f"ls_speculative={self.ls_speculative}")
        if self.backward_mode not in ("scan", "parallel", "timeshard"):
            raise ValueError(
                f"backward_mode={self.backward_mode!r}: expected 'scan', "
                "'parallel' or 'timeshard'")
        if self.inertia_method not in ("auto", "ldl", "bk", "eigh"):
            raise ValueError(
                f"inertia_method={self.inertia_method!r}: expected 'auto', "
                "'ldl', 'bk' or 'eigh'")
        return self
