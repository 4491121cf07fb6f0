"""Rollup application circuits (ref: rollup/proofs/).

The product layer of the stack: private value-note transfers (join_split),
account registration (account), direct exits (escape_hatch), and the
recursive aggregation circuits (rollup, root_rollup) that batch them for
on-chain verification.

Port of aztec_tpu/rollup/'s transaction circuits: ``join_split``,
``account``, their notes, the world state and ``circuit_data``; the
rollup and root-rollup circuits, ``escape_hatch``, ``create_rollup``,
``tree_updates``, ``inner_proof_data`` and ``serialize`` are not ported
yet.
"""
