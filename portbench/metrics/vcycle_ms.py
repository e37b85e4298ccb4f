"""Host ms per multigrid V-cycle: the mean span around the callable that
StructuredMG.preconditioner(J) returns."""


def read(run):
    return run.mean_span_ms("vcycle")
