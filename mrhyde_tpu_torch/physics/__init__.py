from mrhyde_tpu_torch.physics.base import PhysicsModule  # noqa: F401
from mrhyde_tpu_torch.physics.registry import import_physics, register  # noqa: F401
