from mrhyde_tpu_torch.assembly.discretization import Discretization  # noqa: F401
