"""Device busy ms of one evaluate() call: the union of the device's busy
intervals over the jobs profiled after the window, per job.  The card's
time that a validation call takes; the host's speed does not enter it."""


def read(ctx):
    tr = ctx.trace
    traced = [j for j in ctx.jobs if j.traced]
    if tr is None or not traced or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / len(traced)
