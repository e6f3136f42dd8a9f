"""Set-up: from the start of the process to the start of the window
(imports, inputs and weights, the program's build, every kernel's load or
compilation, the warm-up), on the host clock."""


def read(ctx):
    return ctx.setup_s
