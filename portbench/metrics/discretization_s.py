"""Host seconds of the Discretization in set-up: the total of the
program's span problem::discretization."""

from portbench.program_trace import span_total_s


def read(run):
    return span_total_s("problem::discretization")
