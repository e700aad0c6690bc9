"""Arithmetic that several metric readers share."""

from benchmark.harness.work import FP32_FLOP_PER_S

STFT_KERNEL = "stft_fft_kernel"


def untraced(ctx):
    """The window's jobs that ran without the profiler (all of them when
    every job was traced): the stage and wall times of traced jobs carry
    the profiler's cost."""
    return [j for j in ctx.jobs if not j.traced] or ctx.jobs


def _total(jobs, group: str, names):
    """Sum over `jobs` of `Job.stats[group]` at `names` (a name or a tuple
    of names); None when no job holds any of them (a program without
    that span or counter)."""
    names = (names,) if isinstance(names, str) else names
    tables = [j.stats[group] for j in jobs]
    if not any(n in t for t in tables for n in names):
        return None
    return sum(t.get(n, 0) for t in tables for n in names)


def span_ms_per_batch(ctx, name: str):
    """Host ms of the program span `name` per engine batch, over the
    window's untraced jobs (batches as `decode_ms_per_batch.thr` counts
    them)."""
    jobs = untraced(ctx)
    batches = sum(j.batches for j in jobs)
    seconds = _total(jobs, "seconds", name)
    return 1e3 * seconds / batches if seconds is not None and batches else None


def span_ms_per_job(ctx, name: str):
    """Host ms of the program span `name` per job, over the window's
    untraced jobs."""
    jobs = untraced(ctx)
    seconds = _total(jobs, "seconds", name)
    return 1e3 * seconds / len(jobs) if seconds is not None and jobs else None


def counter_share(ctx, part, whole):
    """100 x the program's counters `part` over `whole` (each a name or a
    tuple of names, summed), over the window's untraced jobs.  A counter
    of `part` that never counted reads 0; None when none of `whole` is
    there or they sum to 0."""
    jobs = untraced(ctx)
    w = _total(jobs, "counters", whole)
    if not w:
        return None
    return 100.0 * (_total(jobs, "counters", part) or 0) / w


def span_idle_ms_per_job(ctx, name: str):
    """Device idle ms inside the program spans `name` (their union less the
    device's busy intervals) per traced job, from the trace."""
    tr = ctx.trace
    traced = [j for j in ctx.jobs if j.traced]
    entry = (tr.program or {}).get(name) if tr is not None else None
    if entry is None or not traced:
        return None
    return 1e3 * entry["idle_s"] / len(traced)


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
