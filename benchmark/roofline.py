"""The least time the H100 could take for a kernel's work, from the cell's
shapes alone: every input byte read once and every output byte written once
at the memory rate, against the operations at the vector rate; the larger
of the two. A roofline share is that least time over the measured device
time.

The peaks are NVIDIA's published ones for the H100 SXM (3.35 TB/s of HBM3,
67 TFLOP/s float32 and 33.5 TFLOP/s float64 outside the tensor cores) at
its 700 W power limit; a run records the card's own limit beside them.

The counts are a frozen copy of the formulas the repository's kernel checks
use (`chip_smoke.py`: `sweep_flops`, `bk_sweep_flops`, `forward_flops`,
`kernel_bound`, and the bytes of each kernel's arguments and results),
written out from the shapes: a multiply-add counts two operations, a sine,
cosine or logarithm one.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 33.5e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def bound_s(nbytes, flops, dtype):
    """(least seconds, "bytes" or "operations") for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _sweep_parts(nx, nu, nc):
    m, nk = nu + nc, nx + 1
    tri = sum(m - 1 - j for j in range(m))
    factor = sum(2 * (m - 1 - j) ** 2 + (m - 1 - j) for j in range(m))
    solve = nk * (4 * tri + m)
    assemble = (2 * nx * nx * (nu + nx) + 2 * nx * nx * (nx + nu)
                + 2 * nu * nu * nx + 2 * nu * (nx + nc) + 8 * nu)
    value = 2 * m * nx * (nx + 1) + 2 * nx * (nx + nc) + 2 * m
    gains = 6 * nu + 2 * nu * nx
    return m, nk, factor, solve, assemble, value, gains


def sweep_flops(T, nx, nu, nc, refine):
    """One instance's LDL^T sweep with `refine` refinement steps."""
    m, nk, factor, solve, assemble, value, gains = _sweep_parts(nx, nu, nc)
    resid = 2 * m * m * nk
    return T * (factor + (1 + refine) * (solve + resid) + resid // nk
                + assemble + value + gains)


def bk_sweep_flops(T, nx, nu, nc):
    """One instance's rook Bunch-Kaufman sweep (plain substitution)."""
    m, nk, factor, solve, assemble, value, gains = _sweep_parts(nx, nu, nc)
    return T * (factor + solve + assemble + value + gains)


def sweep_bytes(B, T, nx, nu, nc, dtype):
    """The sweep's 21 inputs (the stage derivatives and the nominal
    iterate, the terminal ones, mu, reg, delta_c) and its results (the 8
    gain tensors, dL, and two flags of a byte)."""
    nz = nx + nu
    stage_in = (nx * nx + nx * nu + nx + nu + nx * nx + nu * nx + nu * nu
                + nc * nx + nc * nu + nz * nz + nc + nu + nu + nc + nu + nu)
    lane_in = nx + nx * nx + 3
    stage_out = 3 * nu + 3 * nu * nx + nc + nc * nx
    values = B * T * (stage_in + stage_out) + B * (lane_in + 1)
    return values * ITEMSIZE[dtype] + 2 * B


def forward_flops(T, nx, nu, nc, lanes):
    """`lanes` closed-loop rollouts with their measures: the affine rows,
    the boundary test, the barrier terms and about 60 for the model's
    stage."""
    rows = 3 * nu + nc
    per_stage = rows * (2 * nx + 2) + nx + 8 * nu + 4 * nc + 4 * nu + 60
    return lanes * T * per_stage


def _forward_shared_values(B, T, nx, nu, nc, theta_values):
    """Bounds, the 8 gain tensors, the nominal x, u, phi, zl, zu and theta."""
    bounds = 2 * T * nu
    gains = T * (3 * nu + nc + 3 * nu * nx + nc * nx)
    nominal = (T + 1) * nx + T * (3 * nu + nc)
    return B * (bounds + gains + nominal + theta_values)


def metrics_bytes(B, T, nx, nu, nc, K, theta_values, dtype):
    """The metrics kernel (K candidates of every lane): the shared inputs,
    the nominal il, iu, mu, tau and the K step sizes; theta, L, J of dtype
    and two flags of a byte for every candidate."""
    values = (_forward_shared_values(B, T, nx, nu, nc, theta_values)
              + B * (2 * T * nu + 2) + K + 3 * B * K)
    return values * ITEMSIZE[dtype] + 2 * B * K


def trial_bytes(B, T, nx, nu, nc, theta_values, dtype):
    """The trial kernel (one step size a lane): the shared inputs and the
    step sizes; the trial x, u, phi, zl, zu, il, iu, c."""
    values = (_forward_shared_values(B, T, nx, nu, nc, theta_values) + B
              + B * ((T + 1) * nx + T * (5 * nu + 2 * nc)))
    return values * ITEMSIZE[dtype]


def sweep_bound_s(cfg, B):
    """Least seconds of one sweep of the configuration's stage solve over
    B instances."""
    T, nx, nu, nc, dt = (cfg[k] for k in ("T", "nx", "nu", "nc", "dtype"))
    flops = (bk_sweep_flops(T, nx, nu, nc) if cfg["stage_solve"] == "bk"
             else sweep_flops(T, nx, nu, nc, refine=1))
    return bound_s(sweep_bytes(B, T, nx, nu, nc, dt), B * flops, dt)[0]


def metrics_bound_s(cfg, B, K):
    T, nx, nu, nc, dt = (cfg[k] for k in ("T", "nx", "nu", "nc", "dtype"))
    return bound_s(metrics_bytes(B, T, nx, nu, nc, K, cfg["theta_values"],
                                 dt), forward_flops(T, nx, nu, nc, B * K),
                   dt)[0]


def trial_bound_s(cfg, B):
    T, nx, nu, nc, dt = (cfg[k] for k in ("T", "nx", "nu", "nc", "dtype"))
    return bound_s(trial_bytes(B, T, nx, nu, nc, cfg["theta_values"], dt),
                   forward_flops(T, nx, nu, nc, B), dt)[0]
