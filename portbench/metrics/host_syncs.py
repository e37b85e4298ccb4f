"""Host reads of device values per steady solve: the mean over the
window's requests of ForwardResult.counts["host_syncs"] (Newton's and the
line search's norms, GMRES's norms and Arnoldi columns, CG's dot
products, the linear solves' residual checks)."""

from portbench.program_trace import mean_count


def read(run):
    return mean_count(run, "host_syncs")
