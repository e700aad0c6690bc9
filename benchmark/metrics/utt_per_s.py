"""Utterances scored in the window's jobs over the wall seconds of those jobs."""


def read(ctx):
    jobs = ctx.jobs
    return sum(j.n_utts for j in jobs) / sum(j.wall_s for j in jobs) if jobs else None
