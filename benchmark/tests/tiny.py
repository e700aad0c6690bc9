"""A cell cut to a size that a CPU test run holds: 2 files of 1.0-1.2 s per
speaker, batch 2, one warm-up job."""

from benchmark.harness import cells


def tiny_cell(name: str, **traffic) -> cells.Cell:
    c = cells.load_cell(name)
    t = dict(c.traffic, warmup_jobs=1, trace_jobs=2)
    t.update(traffic)
    return c._replace(config=dict(c.config, files_per_speaker=2, durations_s=[1.0, 1.2, 1.1]), traffic=t,
                      workload=dict(c.workload, batch_size=2))
