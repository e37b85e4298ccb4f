"""Host ms per linear solve: the mean span around solve_linear_info (a
dense build and LU, or MG-GMRES)."""


def read(run):
    return run.mean_span_ms("linear_solve")
