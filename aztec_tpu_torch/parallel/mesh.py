"""The device mesh of the parallel layer."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one named axis.  Shard d of a
    sharded array lives on ``devices[d]``; a device may repeat (D shards on
    one card)."""

    devices: Tuple[torch.device, ...]
    axis: str = "dp"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @classmethod
    def local(cls, size: int, device="cuda", axis: str = "dp") -> "Mesh":
        """``size`` shards on one device (the card unless ``"cpu"``)."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        return cls((dev,) * size, axis)

    @property
    def size(self) -> int:
        return len(self.devices)
