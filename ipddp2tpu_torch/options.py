"""Solver hyperparameters of the PyTorch/CUDA port.

A copy of the JAX package's option set (`ipddp2tpu/options.py`), itself a
mirror of the reference's (reference: src/options.jl:1-38): the same field
names and the same defaults, so a configuration reads the same in both
packages. The port keeps its own copy because it imports nothing of the JAX
package.

What differs is the set of values the kernel-dispatch knobs take on a GPU
(`backward_kernel`, `forward_kernel`), and that the options the port does
not implement yet are refused by `validate` instead of being
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
                                        # the reference); "parallel" is
                                        # not ported yet
    backward_kernel: str = "auto"       # batched backward-sweep dispatch:
                                        # "auto"  = the hand-written CUDA
                                        #           sweep kernel when the
                                        #           tensors are on a GPU and
                                        #           inertia_method resolves
                                        #           to "ldl", else the plain
                                        #           PyTorch sweep
                                        # "cuda"  = always the CUDA kernel
                                        #           (raises off-GPU or if
                                        #           the build fails)
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
                                        # in one batched rollout and pick the
                                        # largest acceptable (not ported yet)
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
    forward_kernel: str = "auto"        # forward-pass dispatch. The port
                                        # has the plain rollout only, so
                                        # "auto", "xla" (the JAX package's
                                        # name for its un-fused path) and
                                        # "torch" all mean it; asking for a
                                        # fused kernel raises
    auto_tune: bool = True              # unused so far (no autotune
                                        # table for the GPU yet)

    def validate(self) -> "Options":
        """Refuse what the port does not implement yet. Nothing is
        downgraded silently: an option either does what it says or raises."""
        if self.backward_kernel not in ("auto", "cuda", "torch"):
            raise ValueError(
                f"backward_kernel={self.backward_kernel!r}: expected "
                "'auto', 'cuda' or 'torch'")
        if self.forward_kernel not in ("auto", "xla", "torch"):
            raise NotImplementedError(
                f"forward_kernel={self.forward_kernel!r}: the fused forward "
                "kernels (forward_metrics / forward_trial) belong to the "
                "speculative line-search part of the port, not written yet")
        if self.ls_speculative > 0:
            raise NotImplementedError(
                "ls_speculative > 0: the speculative / hybrid line search "
                "is not ported yet (it comes with the forward kernels)")
        if self.backward_mode != "scan":
            raise NotImplementedError(
                f"backward_mode={self.backward_mode!r}: the associative-scan "
                "Riccati pass (parallel/) is not ported yet")
        if self.inertia_method in ("bk", "eigh"):
            raise NotImplementedError(
                f"inertia_method={self.inertia_method!r}: the Bunch-Kaufman "
                "and eigh oracles are not ported yet (they come with the "
                "contact models)")
        if self.inertia_method not in ("auto", "ldl"):
            raise ValueError(f"inertia_method={self.inertia_method!r}")
        return self
