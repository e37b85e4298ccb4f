from mrhyde_tpu_torch.fem.quadrature import cell_quadrature, side_quadrature  # noqa: F401
from mrhyde_tpu_torch.fem.basis import get_basis, Basis  # noqa: F401
