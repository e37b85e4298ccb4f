"""The assembly kernels' share of their roofline: the frozen least bytes
and operations of one residual + Jacobian (roofline/<config>.py) at the
card's published peaks, over the mean device time of every kernel inside
the traced Assembler.res_and_jac spans, in %."""


def read(run):
    return run.roofline_pct()
