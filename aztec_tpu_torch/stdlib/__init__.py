"""In-circuit standard library (ref: stdlib/): the witness wrappers
``FieldT`` and ``BoolT`` (lazy constant composition, gates only where two
witnesses meet) and the in-circuit Pedersen hash over the Turbo fixed-base
gates (``pedersen_circuit``), and what the rollup's transaction circuits
use: ``uint``/``uint32``, ``byte_array``, the in-circuit Blake2s, the
recursion transcript, native-group points, Schnorr verification and Merkle
membership, and the rollup circuits' recursion: ``bigfield`` (Fq in Fr
circuits), ``biggroup`` (BN254 G1 over it) and ``recursion_verifier``
(an unrolled proof verified in-circuit), and the MiMC7 hash
(``mimc_circuit``), and the bit vector, the 16-byte packed byte string
and the in-circuit SHA-256 (``bit_array``, ``packed_byte_array``,
``sha256_circuit``).  Port of aztec_tpu/stdlib/.
"""

from .field_t import FieldT, BoolT, witness, constant, public_witness  # noqa: F401
