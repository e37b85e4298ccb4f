"""Physics module registry: input-deck name -> module class.

`thermal`, `cdr`, `ODE`, `navier stokes`, `Stokes`, `linearelasticity`
and `crystal elasticity` are ported so far. Every other module name the
JAX package registers raises NotImplementedError naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

__all__ = ["register", "import_physics", "available_modules"]

_REGISTRY: dict[str, type] = {}

# deck name -> ROADMAP item of the port that brings it
_NOT_PORTED = {
    "Burgers": "A10", "shallow water": "A10",
    "shallow ice": "A10", "helmholtz": "A10", "hartmann": "A10",
    "Kuramoto-Sivashinsky": "A10", "llamas": "A10",
    "msphasefield": "A10", "phasesolidification": "A10", "VDNS": "A10",
    "inc sat": "A10", "porous": "A10", "cns": "A10",
    "physicsTest": "A10",
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
    import mrhyde_tpu_torch.physics.cdr  # noqa: F401
    import mrhyde_tpu_torch.physics.crystal_elasticity  # noqa: F401
    import mrhyde_tpu_torch.physics.linearelasticity  # noqa: F401
    import mrhyde_tpu_torch.physics.navierstokes  # noqa: F401
    import mrhyde_tpu_torch.physics.ode  # noqa: F401
    import mrhyde_tpu_torch.physics.stokes  # noqa: F401
    import mrhyde_tpu_torch.physics.thermal  # noqa: F401
