"""Client SDK (ref: sdk/src — CoreSdk, user state, note picker, proof
creators).

The reference SDK creates join-split/account proofs client-side over
barretenberg WASM and tracks each user's notes by decrypting viewing keys
from settled blocks.  Same architecture here: key derivation + viewing-key
crypto (viewing_key.py), note store + picker (note_store.py), block-driven
user state (user_state.py), and the CoreSdk facade (core_sdk.py) that
builds txs against a synced Merkle mirror and proves locally or via the
proof service.

Port of aztec_tpu/sdk/: ``CoreSdk`` proves on the card unless given
``device="cpu"``, and draws its randomness from an explicit source.
"""

from .viewing_key import ViewingKey, derive_keys
from .note_store import Note, NoteStore
from .user_state import UserState
from .core_sdk import CoreSdk
