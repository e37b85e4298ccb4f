from mrhyde_tpu_torch.mesh.structured import Mesh, box_mesh  # noqa: F401
