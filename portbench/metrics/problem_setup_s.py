"""Host seconds of Problem(deck): mesh, Discretization, boundary
conditions, assembler and the fused provider (span around the call)."""


def read(run):
    return run.problem_setup_s
