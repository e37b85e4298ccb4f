"""Physics module registry: input-deck name -> module class.

Every module the JAX package registers is ported but those of vector and
trace bases (maxwell, the mixed and hybridized porous and shallow-water
forms, Euler's HDG form), which raise NotImplementedError naming the
ROADMAP item that ports them (A11).
"""

from __future__ import annotations

__all__ = ["register", "import_physics", "available_modules"]

_REGISTRY: dict[str, type] = {}

# deck name -> ROADMAP item of the port that brings it
_NOT_PORTED = {
    "maxwell": "A11", "maxwell control": "A11", "maxwells_freq_pot": "A11",
    "porous mixed": "A11", "porous mixed hybridized": "A11",
    "porous weak Galerkin": "A11", "shallow water hybridized": "A11",
    "Euler": "A11",
}


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
            if n in _NOT_PORTED:
                raise NotImplementedError(
                    f"physics module {n!r} is not ported to "
                    f"mrhyde_tpu_torch yet (ROADMAP {_NOT_PORTED[n]})")
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
    import mrhyde_tpu_torch.physics.hartmann  # noqa: F401
    import mrhyde_tpu_torch.physics.helmholtz  # noqa: F401
    import mrhyde_tpu_torch.physics.incompressible_saturation  # noqa: F401
    import mrhyde_tpu_torch.physics.kuramoto_sivashinsky  # noqa: F401
    import mrhyde_tpu_torch.physics.linearelasticity  # noqa: F401
    import mrhyde_tpu_torch.physics.llamas  # noqa: F401
    import mrhyde_tpu_torch.physics.msphasefield  # noqa: F401
    import mrhyde_tpu_torch.physics.navierstokes  # noqa: F401
    import mrhyde_tpu_torch.physics.ode  # noqa: F401
    import mrhyde_tpu_torch.physics.phasesolidification  # noqa: F401
    import mrhyde_tpu_torch.physics.physics_test  # noqa: F401
    import mrhyde_tpu_torch.physics.porous  # noqa: F401
    import mrhyde_tpu_torch.physics.shallowice  # noqa: F401
    import mrhyde_tpu_torch.physics.shallowwater  # noqa: F401
    import mrhyde_tpu_torch.physics.stokes  # noqa: F401
    import mrhyde_tpu_torch.physics.thermal  # noqa: F401
    import mrhyde_tpu_torch.physics.variable_density_ns  # noqa: F401
