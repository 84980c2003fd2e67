"""Benchmark problem definitions of the port (counterparts of
`ipddp2tpu/models/`). So far: `concar` and `double_integrator`."""
