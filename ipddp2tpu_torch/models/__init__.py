"""Benchmark problem definitions of the port (counterparts of
`ipddp2tpu/models/`), each with its device functions under
`ops/csrc/models/<name>.cuh` for the forward kernels:

    concar, concar_quad                 constrained car (L1 / quadratic slack
                                        penalty), the main path's model
    double_integrator                   absolute-work objective
    quadrotor, cartpole_swingup         smooth, bounds only (nc = 0)
    acrobot, cartpole, pushing          contact models (`contact=True`:
                                        inertia_method="auto" takes rook
                                        Bunch-Kaufman)

Every module but double_integrator has `from_params(rows)`, which turns rows
of `experiments/params/<PARAMS>` (read with `convert.params_rows`) into
batched (theta, bounds, x1, u0).
"""

__all__ = ["acrobot", "cartpole", "cartpole_swingup", "concar",
           "concar_quad", "double_integrator", "pushing", "quadrotor"]
