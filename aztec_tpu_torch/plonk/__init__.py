"""Standard PLONK and TurboPlonk proof systems (ref: plonk/proof_system/)."""

from .composer import (AddTriple, MulTriple, PolyTriple,  # noqa: F401
                       StandardComposer, TurboComposer)
