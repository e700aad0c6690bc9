"""Arithmetic that several metric readers share."""

from benchmark.harness.work import FP32_FLOP_PER_S

STFT_KERNEL = "stft_fft_kernel"


def untraced(ctx):
    """The window's jobs that ran without the profiler (all of them when
    every job was traced): the stage and wall times of traced jobs carry
    the profiler's cost."""
    return [j for j in ctx.jobs if not j.traced] or ctx.jobs


def stft_roofline(ctx):
    """100 x the kernel's least seconds for the traced jobs' |STFT| work over
    the device seconds of the kernels of that name.  None when the launches
    per batch differ from what the work count assumes."""
    tr = ctx.trace
    traced = [j for j in ctx.jobs if j.traced]
    if tr is None or not traced:
        return None
    batches = sum(j.batches for j in traced)
    launches = sum(j.launches for j in traced)
    if launches != batches * ctx.expected_launches_per_batch:
        ctx.log(f"stft_kernel_roofline: {launches} launches over {batches} batches, the count assumes "
                f"{ctx.expected_launches_per_batch} a batch: not read")
        return None
    kernel_s = sum(s for name, s in tr.by_name.items() if STFT_KERNEL in name)
    if kernel_s <= 0:
        return None
    return 100.0 * ctx.work["stft_least_s"] * len(traced) / kernel_s


def mfu(ctx):
    """100 x the algorithm's FLOP over the wall seconds of the window's
    untraced jobs (all jobs where every one was traced) over the fp32 peak."""
    jobs = untraced(ctx)
    if not jobs:
        return None
    return 100.0 * ctx.work["flop"] * len(jobs) / sum(j.wall_s for j in jobs) / FP32_FLOP_PER_S


def idle_share(ctx):
    """100 x (1 - device busy seconds a job / wall seconds a job): busy from
    the trace of the traced jobs, wall from the window's untraced jobs.  A
    traced job's wall time carries the profiler's host cost (all of it
    falls between kernels in a host-bound cell), the device time of its
    kernels does not; the traffic makes the same work every job."""
    tr = ctx.trace
    traced = [j for j in ctx.jobs if j.traced]
    plain = [j for j in ctx.jobs if not j.traced]
    if tr is None or not traced or not plain or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - (tr.busy_s / len(traced)) / (sum(j.wall_s for j in plain) / len(plain)))
