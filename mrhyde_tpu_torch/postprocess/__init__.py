from mrhyde_tpu_torch.postprocess.errors import ErrorCalculator  # noqa: F401
