"""Rollup protocol constants (ref: rollup/constants.hpp,
rollup/proofs/notes/constants.hpp).

Port of aztec_tpu/rollup/constants.py, host Python: the same inputs give the
same values.
"""

# Tree depths (ref: rollup/constants.hpp:5-7).  Production values; the
# circuits below derive actual depth from the hash paths they are given so
# tests can run shallow trees.
DATA_TREE_DEPTH = 32
NULL_TREE_DEPTH = 256
ROOT_TREE_DEPTH = 28

MAX_TXS_BIT_LENGTH = 10
TX_FEE_BIT_LENGTH = 254 - MAX_TXS_BIT_LENGTH

NUM_ASSETS_BIT_LENGTH = 2
NUM_ASSETS = 1 << NUM_ASSETS_BIT_LENGTH

# note constants (ref: notes/constants.hpp)
NOTE_VALUE_BIT_LENGTH = 252

TX_NOTE_HASH_INDEX = 0
TX_NOTE_ACCOUNT_PRIVATE_KEY_INDEX = 6
TX_NOTE_NULLIFIER_INDEX = 7

ACCOUNT_NOTE_HASH_INDEX = 20
ACCOUNT_ALIAS_ID_HASH_INDEX = 21
ACCOUNT_GIBBERISH_HASH_INDEX = 22
