"""Device time of the kernels launched inside the program's
"dispatch.testee.vocoder" spans (NVSRTestee's vocoder) per engine batch,
over the traced jobs.  An engine batch runs the testee once per spec."""


def read(ctx):
    tr = ctx.trace
    entry = (tr.program or {}).get("dispatch.testee.vocoder") if tr is not None else None
    batches = sum(j.batches for j in ctx.jobs if j.traced)
    if entry is None or not batches:
        return None
    return 1e3 * entry["device_s"] / batches
