from mrhyde_tpu_torch.analysis.parameters import (  # noqa: F401
    ParameterManager, ParamSpec)
