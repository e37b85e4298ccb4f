"""Host ms per residual + Jacobian: the mean span around
Assembler.res_and_jac."""


def read(run):
    return run.mean_span_ms("assembly")
