"""Owned-note tracking + note picker (ref: sdk/src/note_picker + database
note tables).

The picker mirrors the reference's strategy: join_split spends at most two
notes, so pick the smallest pair covering the requested value (minimising
dust), falling back to the single smallest sufficient note.

Port of aztec_tpu/sdk/note_store.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..rollup.notes_native import ValueNote


@dataclasses.dataclass
class Note:
    note: ValueNote
    index: int              # data-tree leaf index
    nullifier: int = 0      # computed at spend time
    nullified: bool = False
    pending: bool = False   # created locally, not yet settled


class NoteStore:
    def __init__(self):
        self._notes: List[Note] = []

    def add(self, n: Note):
        if any(e.index == n.index for e in self._notes):
            return
        self._notes.append(n)

    def mark_nullified(self, nullifier: int):
        for n in self._notes:
            if n.nullifier == nullifier:
                n.nullified = True

    def settle(self, index: int):
        for n in self._notes:
            if n.index == index:
                n.pending = False

    def spendable(self, asset_id: int) -> List[Note]:
        return sorted(
            (n for n in self._notes
             if not n.nullified and not n.pending
             and n.note.asset_id == asset_id),
            key=lambda n: n.note.value)

    def balance(self, asset_id: int) -> int:
        return sum(n.note.value for n in self.spendable(asset_id))

    def pick(self, asset_id: int, value: int) -> Optional[List[Note]]:
        """<=2 notes covering `value` (ref: note_picker pick(2))."""
        avail = self.spendable(asset_id)
        for n in avail:  # smallest single note that covers
            if n.note.value >= value:
                return [n]
        best: Optional[Tuple[int, Note, Note]] = None
        for i, a in enumerate(avail):  # smallest covering pair
            for b in avail[i + 1:]:
                s = a.note.value + b.note.value
                if s >= value and (best is None or s < best[0]):
                    best = (s, a, b)
        return [best[1], best[2]] if best else None
