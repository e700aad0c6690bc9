"""The rows the engine's batches carry: the program's counter
`rows_dispatched` (`_pack_batch`) over the engine batches of the window's
untraced jobs.  Below the cell's batch size as far as buckets' remainders
go out with only their rows."""

from benchmark.metrics._common import untraced


def read(ctx):
    jobs = untraced(ctx)
    rows = sum(j.stats["counters"].get("rows_dispatched", 0) for j in jobs)
    batches = sum(j.batches for j in jobs)
    return rows / batches if rows and batches else None
