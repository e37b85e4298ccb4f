from mrhyde_tpu_torch.solvers.linear import solve_linear  # noqa: F401
from mrhyde_tpu_torch.solvers.nonlinear import newton_solve  # noqa: F401
