"""Physics module registry: input-deck name -> module class.

Every module the JAX package registers is ported, under the same deck
names; a deck's `Subgrid` sublist names its fine physics from the same
registry (multiscale/subgrid.py).
"""

from __future__ import annotations

__all__ = ["register", "import_physics", "available_modules"]

_REGISTRY: dict[str, type] = {}


def register(deck_name: str):
    def deco(cls):
        _REGISTRY[deck_name] = cls
        return cls
    return deco


def available_modules():
    _ensure_imported()
    return sorted(_REGISTRY)


def import_physics(names, settings=None, dim=2):
    """Instantiate physics modules from deck names (comma list or list)."""
    _ensure_imported()
    if isinstance(names, str):
        names = [n.strip() for n in names.split(",") if n.strip()]
    modules = []
    for n in names:
        if n not in _REGISTRY:
            raise KeyError(f"unknown physics module {n!r}; "
                           f"available: {available_modules()}")
        modules.append(_REGISTRY[n](settings or {}, dim))
    return modules


def _ensure_imported():
    # import the module files so their @register decorators run
    import mrhyde_tpu_torch.physics.burgers  # noqa: F401
    import mrhyde_tpu_torch.physics.cdr  # noqa: F401
    import mrhyde_tpu_torch.physics.cns  # noqa: F401
    import mrhyde_tpu_torch.physics.crystal_elasticity  # noqa: F401
    import mrhyde_tpu_torch.physics.euler  # noqa: F401
    import mrhyde_tpu_torch.physics.hartmann  # noqa: F401
    import mrhyde_tpu_torch.physics.helmholtz  # noqa: F401
    import mrhyde_tpu_torch.physics.incompressible_saturation  # noqa: F401
    import mrhyde_tpu_torch.physics.kuramoto_sivashinsky  # noqa: F401
    import mrhyde_tpu_torch.physics.linearelasticity  # noqa: F401
    import mrhyde_tpu_torch.physics.llamas  # noqa: F401
    import mrhyde_tpu_torch.physics.maxwell  # noqa: F401
    import mrhyde_tpu_torch.physics.maxwells_fp  # noqa: F401
    import mrhyde_tpu_torch.physics.msphasefield  # noqa: F401
    import mrhyde_tpu_torch.physics.navierstokes  # noqa: F401
    import mrhyde_tpu_torch.physics.ode  # noqa: F401
    import mrhyde_tpu_torch.physics.phasesolidification  # noqa: F401
    import mrhyde_tpu_torch.physics.physics_test  # noqa: F401
    import mrhyde_tpu_torch.physics.porous  # noqa: F401
    import mrhyde_tpu_torch.physics.porous_mixed  # noqa: F401
    import mrhyde_tpu_torch.physics.porous_mixed_hybrid  # noqa: F401
    import mrhyde_tpu_torch.physics.porous_weak_galerkin  # noqa: F401
    import mrhyde_tpu_torch.physics.shallowice  # noqa: F401
    import mrhyde_tpu_torch.physics.shallowwater  # noqa: F401
    import mrhyde_tpu_torch.physics.shallowwater_hybridized  # noqa: F401
    import mrhyde_tpu_torch.physics.stokes  # noqa: F401
    import mrhyde_tpu_torch.physics.thermal  # noqa: F401
    import mrhyde_tpu_torch.physics.variable_density_ns  # noqa: F401
