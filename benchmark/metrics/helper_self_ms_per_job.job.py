"""The helper's own host time per job: the program's `job` span less its
`job.evaluate_files` span (listing the tree, the journal, aggregation, the
results JSON), over the window's untraced jobs."""

from benchmark.metrics._common import span_ms_per_job


def read(ctx):
    job, files = span_ms_per_job(ctx, "job"), span_ms_per_job(ctx, "job.evaluate_files")
    return None if job is None or files is None else job - files
