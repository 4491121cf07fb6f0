"""Standard, Turbo, Ultra and MiMC PLONK proof systems (ref:
plonk/proof_system/)."""

from .composer import (AddTriple, MiMCComposer, MulTriple,  # noqa: F401
                       PolyTriple, StandardComposer, TurboComposer,
                       UltraComposer)
