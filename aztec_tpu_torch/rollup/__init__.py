"""Rollup application circuits (ref: rollup/proofs/).

The product layer of the stack: private value-note transfers (join_split),
account registration (account), direct exits (escape_hatch), and the
recursive aggregation circuits (rollup, root_rollup) that batch them for
on-chain verification.

Port of aztec_tpu/rollup/: the transaction circuits (``join_split``,
``account``, their notes, the world state, ``circuit_data``) and the
aggregation circuits (``rollup_circuit``, ``root_rollup_circuit``, with
``tree_updates``, ``inner_proof_data``, ``serialize``, ``create_rollup``);
``escape_hatch`` is not ported yet.
"""
