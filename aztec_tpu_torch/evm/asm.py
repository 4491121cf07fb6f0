"""Tiny EVM assembler: mnemonics + labels -> bytecode.

Used by contracts/evm_verifier.py to emit the executable verifier.  PUSH
operands are auto-sized; label references assemble as PUSH2 (all verifier
programs are < 64 KB).

Port of aztec_tpu/evm/asm.py.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

OPS = {
    "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
    "MOD": 0x06, "ADDMOD": 0x08, "MULMOD": 0x09, "EXP": 0x0A,
    "LT": 0x10, "GT": 0x11, "EQ": 0x14, "ISZERO": 0x15,
    "AND": 0x16, "OR": 0x17, "XOR": 0x18, "NOT": 0x19, "BYTE": 0x1A,
    "SHL": 0x1B, "SHR": 0x1C,
    "KECCAK256": 0x20,
    "CALLVALUE": 0x34, "CALLDATALOAD": 0x35, "CALLDATASIZE": 0x36,
    "CALLDATACOPY": 0x37, "RETURNDATASIZE": 0x3D,
    "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52, "MSTORE8": 0x53,
    "JUMP": 0x56, "JUMPI": 0x57, "PC": 0x58, "MSIZE": 0x59, "GAS": 0x5A,
    "JUMPDEST": 0x5B,
    "STATICCALL": 0xFA, "RETURN": 0xF3, "REVERT": 0xFD, "INVALID": 0xFE,
}
for _i in range(1, 17):
    OPS[f"DUP{_i}"] = 0x7F + _i
    OPS[f"SWAP{_i}"] = 0x8F + _i


class Assembler:
    """emit('MSTORE'), push(value), label()/jump() based program builder."""

    def __init__(self):
        self.items: List[Tuple[str, Union[int, str, None]]] = []
        self._label_count = 0

    def emit(self, mnemonic: str):
        self.items.append(("op", OPS[mnemonic]))
        return self

    def push(self, value: int):
        assert 0 <= value < (1 << 256)
        self.items.append(("push", value))
        return self

    def new_label(self) -> str:
        self._label_count += 1
        return f"L{self._label_count}"

    def label(self, name: str):
        self.items.append(("label", name))
        return self

    def push_label(self, name: str):
        self.items.append(("pushlabel", name))
        return self

    def jump(self, name: str):
        return self.push_label(name).emit("JUMP")

    def jumpi(self, name: str):
        return self.push_label(name).emit("JUMPI")

    def assemble(self) -> bytes:
        # pass 1: layout
        addr: Dict[str, int] = {}
        pc = 0
        sizes = []
        for kind, arg in self.items:
            if kind == "op":
                sizes.append(1)
            elif kind == "push":
                n = max((arg.bit_length() + 7) // 8, 1)
                sizes.append(1 + n)
            elif kind == "pushlabel":
                sizes.append(3)  # PUSH2
            elif kind == "label":
                addr[arg] = pc
                sizes.append(1)  # JUMPDEST
            pc += sizes[-1]
        # pass 2: emit
        out = bytearray()
        for (kind, arg), _sz in zip(self.items, sizes):
            if kind == "op":
                out.append(arg)
            elif kind == "push":
                n = max((arg.bit_length() + 7) // 8, 1)
                out.append(0x5F + n)
                out.extend(arg.to_bytes(n, "big"))
            elif kind == "pushlabel":
                out.append(0x61)  # PUSH2
                out.extend(addr[arg].to_bytes(2, "big"))
            elif kind == "label":
                out.append(OPS["JUMPDEST"])
        return bytes(out)
