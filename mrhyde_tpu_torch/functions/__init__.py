from mrhyde_tpu_torch.functions.parser import parse_expression  # noqa: F401
from mrhyde_tpu_torch.functions.manager import FunctionManager  # noqa: F401
