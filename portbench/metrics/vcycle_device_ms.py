"""Device ms per multigrid V-cycle: the device time of the kernels,
copies and sets launched inside the program's mrhyde::mg::vcycle ranges
of the profiled slice, per range (portbench/program_trace.py)."""

from portbench.program_trace import run_device_ms


def read(run):
    return run_device_ms(run, "mg::vcycle")
