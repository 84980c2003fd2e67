"""setup_s: seconds from the start of the process to the start of the
window: imports, CUDA context, the kernels built or loaded, the instances
drawn and put on the device, the warm-up solve (host clock)."""


def read(run):
    return run.setup_s
