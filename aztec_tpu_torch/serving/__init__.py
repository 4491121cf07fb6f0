"""Serving layer: proof workers and job protocol.

The reference's serving shape (SURVEY.md §2.2):
halloumi spawns a long-lived rollup_cli proof worker over stdin/stdout with
length-prefixed big-endian binary framing (rollup/rollup_cli/main.cpp:115-153,
halloumi cli_proof_generator.ts:53-90).  ``proof_worker`` speaks the same
framing so an halloumi-style HTTP front end can drive this framework
unchanged.

Port of aztec_tpu/serving/: the worker proves on the card unless it is
given ``device="cpu"``; the tx-rollup and root-rollup requests (ids 0 and
1) answer a failed frame until the rollup circuits are ported.
"""
