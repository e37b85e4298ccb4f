"""Host ms of the initial condition per forward: the median of the
program's span forward::initial_state (its L2 projection: mass matrix,
right-hand side, CG solve), which reads host values, so ends with its
device work."""

from portbench.program_trace import span_median_ms


def read(run):
    return span_median_ms("forward::initial_state")
