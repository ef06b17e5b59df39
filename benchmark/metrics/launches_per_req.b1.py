"""launches_per_req.b1: kernel launches in the trace per traced request."""


def read(run):
    if run.trace_read is None or not run.profiled:
        return None
    return run.trace_read["kernels"] / len(run.profiled)
