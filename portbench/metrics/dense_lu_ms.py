"""Device ms per dense LU solve: the device time of the kernels, copies
and sets launched inside the program's mrhyde::linear::lu ranges
(torch.linalg.solve of the densified Jacobian) of the profiled slice, per
range (portbench/program_trace.py)."""

from portbench.program_trace import run_device_ms


def read(run):
    return run_device_ms(run, "linear::lu")
