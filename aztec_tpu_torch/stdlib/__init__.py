"""In-circuit standard library (ref: stdlib/): the witness wrappers
``FieldT`` and ``BoolT`` (lazy constant composition, gates only where two
witnesses meet) and the in-circuit Pedersen hash over the Turbo fixed-base
gates (``pedersen_circuit``).  Port of aztec_tpu/stdlib's ``field_t`` and
``pedersen_circuit``; the rest of that package is not ported yet.
"""

from .field_t import FieldT, BoolT, witness, constant, public_witness  # noqa: F401
