"""setup_s: seconds from the start of the process to the opening of the
window (imports, the kernel library, data, index build, warm-up)."""


def read(ctx):
    return ctx.setup_s
