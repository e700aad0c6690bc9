"""Device time of the kernels launched inside the benchmark's "testee" span
(around each infer_batch call) per engine batch, over the traced jobs.  An
engine batch calls the testee once per spec."""


def read(ctx):
    tr = ctx.trace
    calls = tr.span_count.get("testee", 0) if tr else 0
    if not calls or "testee" not in tr.span_device_s:
        return None
    return tr.span_device_s["testee"] / (calls / ctx.specs) * 1e3
