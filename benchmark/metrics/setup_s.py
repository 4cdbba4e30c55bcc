"""setup_s: seconds from the start of the process to the start of the
window (imports, the device, the traffic, the program's state, its kernels
built or loaded, the warm-up)."""


def read(ctx):
    return ctx.setup_s
