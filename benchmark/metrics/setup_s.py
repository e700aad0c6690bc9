"""Process start to the first timed job: imports, kernels (built or from
the checkout's cache), the dataset, the testee, the warm-up jobs."""


def read(ctx):
    return ctx.setup_s
