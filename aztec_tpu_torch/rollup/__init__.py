"""Rollup application circuits (ref: rollup/proofs/).

The product layer of the stack: private value-note transfers (join_split),
account registration (account), direct exits (escape_hatch), and the
recursive aggregation circuits (rollup, root_rollup) that batch them for
on-chain verification.

Port of aztec_tpu/rollup/: the transaction circuits (``join_split``,
``account``, their notes, the world state, ``circuit_data``) and the
aggregation circuits (``rollup_circuit``, ``root_rollup_circuit``, with
``tree_updates``, ``inner_proof_data``, ``serialize``, ``create_rollup``)
and the exit circuit (``escape_hatch``, exported here).
"""


def __getattr__(name):
    # imported on first use, so that importing one rollup module does not
    # import the escape hatch's whole circuit stack
    if name in ("EscapeHatchTx", "escape_hatch_circuit"):
        from . import escape_hatch

        return getattr(escape_hatch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
