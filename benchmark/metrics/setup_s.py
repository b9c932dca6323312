"""setup_s (host clock): process start to the window's start: imports, the
CUDA context, the kernels' libraries, the model, Newton and warm-up."""


def read(ctx):
    return ctx["setup_s"]
