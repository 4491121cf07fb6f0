"""Minimal EVM bytecode interpreter (execution layer for the on-chain
verifier; ref environment: blockchain/contracts + ganache in the
reference's test stack).

Covers the opcode subset a PLONK verifier exercises: 256-bit arithmetic
(incl. ADDMOD/MULMOD), comparisons/bitwise, KECCAK256, calldata/memory,
control flow, RETURN/REVERT, and STATICCALL to the BN254 precompiles —
implemented with this framework's own host pairing (curves/pairing.py), so
an ecPairing acceptance here is backed by the same optimal-ate
implementation the native verifier uses:

  0x02 SHA256, 0x05 MODEXP, 0x06 ecAdd, 0x07 ecMul, 0x08 ecPairing

Gas is metered with the Istanbul costs for the ops used (memory expansion
included), so the generated verifier reports a meaningful gas figure next
to the reference's TurboVerifier.

Port of aztec_tpu/evm/interpreter.py: the same opcodes, precompiles and gas.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

from ..crypto.keccak import keccak256

U256 = (1 << 256) - 1
SIGN = 1 << 255


class EvmRevert(Exception):
    def __init__(self, data: bytes):
        super().__init__(f"revert: {data.hex()}")
        self.data = data


class EvmError(Exception):
    pass


def _bn254():
    from ..curves import pairing as pr
    from ..ff.bn254 import FQ_MOD, FR_MOD

    return pr, FQ_MOD, FR_MOD


GAS = {
    "base": 2, "verylow": 3, "low": 5, "mid": 8, "high": 10,
    "addmod": 8, "mulmod": 8, "jumpdest": 1,
    "keccak_base": 30, "keccak_word": 6, "memory_word": 3,
    "staticcall": 700,
    "ecadd": 150, "ecmul": 6000, "ecpairing_base": 45000,
    "ecpairing_pair": 34000, "sha256_base": 60, "sha256_word": 12,
}


class EVM:
    """One-shot message-call executor: run(code, calldata) -> return data."""

    def __init__(self, gas_limit: int = 100_000_000):
        self.gas_limit = gas_limit
        self.gas_used = 0

    # -- memory helpers --------------------------------------------------------

    def _mem_expand(self, mem: bytearray, end: int):
        if end > len(mem):
            new_words = (end + 31) // 32
            old_words = (len(mem) + 31) // 32
            # quadratic term omitted below 1 MB; linear word cost charged
            self._use((new_words - old_words) * GAS["memory_word"])
            mem.extend(b"\x00" * (new_words * 32 - len(mem)))

    def _use(self, g: int):
        self.gas_used += g
        if self.gas_used > self.gas_limit:
            raise EvmError("out of gas")

    # -- precompiles -----------------------------------------------------------

    def _precompile(self, addr: int, data: bytes) -> bytes:
        pr, FQ, FR = _bn254()
        if addr == 2:  # SHA256
            self._use(GAS["sha256_base"]
                      + GAS["sha256_word"] * ((len(data) + 31) // 32))
            return hashlib.sha256(data).digest()
        if addr == 5:  # MODEXP (EIP-198)
            bl = int.from_bytes(data[0:32], "big")
            el = int.from_bytes(data[32:64], "big")
            ml = int.from_bytes(data[64:96], "big")
            body = data[96:96 + bl + el + ml].ljust(bl + el + ml, b"\x00")
            b = int.from_bytes(body[:bl], "big")
            e = int.from_bytes(body[bl:bl + el], "big")
            m = int.from_bytes(body[bl + el:], "big")
            self._use(200)  # flat approximation of the EIP-2565 formula
            r = pow(b, e, m) if m else 0
            return r.to_bytes(ml, "big")
        if addr == 6:  # ecAdd
            self._use(GAS["ecadd"])
            x1, y1, x2, y2 = (
                int.from_bytes(data[i:i + 32].ljust(32, b"\x00"), "big")
                for i in range(0, 128, 32)
            )
            p = None if (x1 | y1) == 0 else (x1, y1)
            q = None if (x2 | y2) == 0 else (x2, y2)
            for pt in (p, q):
                if pt is not None and not _on_g1(pt, FQ):
                    raise EvmError("ecAdd: point not on curve")
            r = pr.g1_add(p, q)
            return _g1_bytes(r)
        if addr == 7:  # ecMul
            self._use(GAS["ecmul"])
            x = int.from_bytes(data[0:32].ljust(32, b"\x00"), "big")
            y = int.from_bytes(data[32:64].ljust(32, b"\x00"), "big")
            k = int.from_bytes(data[64:96].ljust(32, b"\x00"), "big")
            p = None if (x | y) == 0 else (x, y)
            if p is not None and not _on_g1(p, FQ):
                raise EvmError("ecMul: point not on curve")
            r = pr.g1_mul(k, p) if p is not None else None
            return _g1_bytes(r)
        if addr == 8:  # ecPairing
            if len(data) % 192:
                raise EvmError("ecPairing: bad input length")
            npairs = len(data) // 192
            self._use(GAS["ecpairing_base"] + GAS["ecpairing_pair"] * npairs)
            pairs = []
            for i in range(npairs):
                seg = data[i * 192:(i + 1) * 192]
                ax = int.from_bytes(seg[0:32], "big")
                ay = int.from_bytes(seg[32:64], "big")
                # EVM G2 encoding: x = x_im || x_re, y = y_im || y_re
                bxi = int.from_bytes(seg[64:96], "big")
                bxr = int.from_bytes(seg[96:128], "big")
                byi = int.from_bytes(seg[128:160], "big")
                byr = int.from_bytes(seg[160:192], "big")
                g1 = None if (ax | ay) == 0 else (ax, ay)
                g2 = (None if (bxi | bxr | byi | byr) == 0
                      else ((bxr, bxi), (byr, byi)))
                if g1 is not None and not _on_g1(g1, FQ):
                    raise EvmError("ecPairing: g1 not on curve")
                if g1 is None or g2 is None:
                    continue  # pairing with infinity contributes 1
                pairs.append((g1, g2))
            ok = pr.pairing_check(pairs)
            return (1 if ok else 0).to_bytes(32, "big")
        raise EvmError(f"unknown precompile {addr}")

    # -- main loop ---------------------------------------------------------------

    def run(self, code: bytes, calldata: bytes = b"") -> bytes:
        st: List[int] = []
        mem = bytearray()
        pc = 0
        jumpdests = _scan_jumpdests(code)

        def push(v: int):
            if len(st) >= 1024:
                raise EvmError("stack overflow")
            st.append(v & U256)

        def pop() -> int:
            if not st:
                raise EvmError("stack underflow")
            return st.pop()

        while pc < len(code):
            op = code[pc]
            pc += 1

            if 0x60 <= op <= 0x7F:  # PUSH1..PUSH32
                n = op - 0x5F
                push(int.from_bytes(code[pc:pc + n], "big"))
                pc += n
                self._use(GAS["verylow"])
            elif 0x80 <= op <= 0x8F:  # DUP1..16
                n = op - 0x7F
                if len(st) < n:
                    raise EvmError("stack underflow")
                push(st[-n])
                self._use(GAS["verylow"])
            elif 0x90 <= op <= 0x9F:  # SWAP1..16
                n = op - 0x8F
                if len(st) < n + 1:
                    raise EvmError("stack underflow")
                st[-1], st[-n - 1] = st[-n - 1], st[-1]
                self._use(GAS["verylow"])
            elif op == 0x01:  # ADD
                push(pop() + pop())
                self._use(GAS["verylow"])
            elif op == 0x02:  # MUL
                push(pop() * pop())
                self._use(GAS["low"])
            elif op == 0x03:  # SUB
                a = pop()
                push(a - pop())
                self._use(GAS["verylow"])
            elif op == 0x04:  # DIV
                a, b = pop(), pop()
                push(a // b if b else 0)
                self._use(GAS["low"])
            elif op == 0x06:  # MOD
                a, b = pop(), pop()
                push(a % b if b else 0)
                self._use(GAS["low"])
            elif op == 0x08:  # ADDMOD
                a, b, m = pop(), pop(), pop()
                push((a + b) % m if m else 0)
                self._use(GAS["addmod"])
            elif op == 0x09:  # MULMOD
                a, b, m = pop(), pop(), pop()
                push((a * b) % m if m else 0)
                self._use(GAS["mulmod"])
            elif op == 0x0A:  # EXP
                a, e = pop(), pop()
                self._use(10 + 50 * ((e.bit_length() + 7) // 8))
                push(pow(a, e, 1 << 256))
            elif op == 0x10:  # LT
                a, b = pop(), pop()
                push(1 if a < b else 0)
                self._use(GAS["verylow"])
            elif op == 0x11:  # GT
                a, b = pop(), pop()
                push(1 if a > b else 0)
                self._use(GAS["verylow"])
            elif op == 0x14:  # EQ
                push(1 if pop() == pop() else 0)
                self._use(GAS["verylow"])
            elif op == 0x15:  # ISZERO
                push(1 if pop() == 0 else 0)
                self._use(GAS["verylow"])
            elif op == 0x16:  # AND
                push(pop() & pop())
                self._use(GAS["verylow"])
            elif op == 0x17:  # OR
                push(pop() | pop())
                self._use(GAS["verylow"])
            elif op == 0x18:  # XOR
                push(pop() ^ pop())
                self._use(GAS["verylow"])
            elif op == 0x19:  # NOT
                push(~pop())
                self._use(GAS["verylow"])
            elif op == 0x1A:  # BYTE
                i, x = pop(), pop()
                push((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
                self._use(GAS["verylow"])
            elif op == 0x1B:  # SHL
                s, v = pop(), pop()
                push(v << s if s < 256 else 0)
                self._use(GAS["verylow"])
            elif op == 0x1C:  # SHR
                s, v = pop(), pop()
                push(v >> s if s < 256 else 0)
                self._use(GAS["verylow"])
            elif op == 0x20:  # KECCAK256
                off, size = pop(), pop()
                self._mem_expand(mem, off + size)
                self._use(GAS["keccak_base"]
                          + GAS["keccak_word"] * ((size + 31) // 32))
                push(int.from_bytes(keccak256(bytes(mem[off:off + size])),
                                    "big"))
            elif op == 0x34:  # CALLVALUE
                push(0)
                self._use(GAS["base"])
            elif op == 0x35:  # CALLDATALOAD
                off = pop()
                push(int.from_bytes(
                    calldata[off:off + 32].ljust(32, b"\x00"), "big"))
                self._use(GAS["verylow"])
            elif op == 0x36:  # CALLDATASIZE
                push(len(calldata))
                self._use(GAS["base"])
            elif op == 0x37:  # CALLDATACOPY
                dst, src, size = pop(), pop(), pop()
                self._mem_expand(mem, dst + size)
                self._use(GAS["verylow"]
                          + GAS["memory_word"] * ((size + 31) // 32))
                mem[dst:dst + size] = calldata[src:src + size].ljust(
                    size, b"\x00")
            elif op == 0x50:  # POP
                pop()
                self._use(GAS["base"])
            elif op == 0x51:  # MLOAD
                off = pop()
                self._mem_expand(mem, off + 32)
                push(int.from_bytes(mem[off:off + 32], "big"))
                self._use(GAS["verylow"])
            elif op == 0x52:  # MSTORE
                off, val = pop(), pop()
                self._mem_expand(mem, off + 32)
                mem[off:off + 32] = val.to_bytes(32, "big")
                self._use(GAS["verylow"])
            elif op == 0x53:  # MSTORE8
                off, val = pop(), pop()
                self._mem_expand(mem, off + 1)
                mem[off] = val & 0xFF
                self._use(GAS["verylow"])
            elif op == 0x56:  # JUMP
                dst = pop()
                if dst not in jumpdests:
                    raise EvmError(f"bad jump {dst}")
                pc = dst
                self._use(GAS["mid"])
            elif op == 0x57:  # JUMPI
                dst, cond = pop(), pop()
                if cond:
                    if dst not in jumpdests:
                        raise EvmError(f"bad jumpi {dst}")
                    pc = dst
                self._use(GAS["high"])
            elif op == 0x58:  # PC
                push(pc - 1)
                self._use(GAS["base"])
            elif op == 0x59:  # MSIZE
                push(len(mem))
                self._use(GAS["base"])
            elif op == 0x5A:  # GAS
                push(self.gas_limit - self.gas_used)
                self._use(GAS["base"])
            elif op == 0x5B:  # JUMPDEST
                self._use(GAS["jumpdest"])
            elif op == 0xFA:  # STATICCALL
                _gas, addr, aoff, asize, roff, rsize = (
                    pop(), pop(), pop(), pop(), pop(), pop())
                self._mem_expand(mem, aoff + asize)
                self._use(GAS["staticcall"])
                try:
                    ret = self._precompile(addr,
                                           bytes(mem[aoff:aoff + asize]))
                    ok = 1
                except EvmError:
                    ret, ok = b"", 0
                self._last_ret = ret
                self._mem_expand(mem, roff + rsize)
                mem[roff:roff + min(rsize, len(ret))] = ret[:rsize]
                push(ok)
            elif op == 0x3D:  # RETURNDATASIZE
                push(len(getattr(self, "_last_ret", b"")))
                self._use(GAS["base"])
            elif op == 0xF3:  # RETURN
                off, size = pop(), pop()
                self._mem_expand(mem, off + size)
                return bytes(mem[off:off + size])
            elif op == 0xFD:  # REVERT
                off, size = pop(), pop()
                self._mem_expand(mem, off + size)
                raise EvmRevert(bytes(mem[off:off + size]))
            elif op == 0x00:  # STOP
                return b""
            elif op == 0xFE:  # INVALID
                raise EvmError("invalid opcode 0xfe")
            else:
                raise EvmError(f"unimplemented opcode 0x{op:02x} @ {pc-1}")
        return b""


def _scan_jumpdests(code: bytes) -> set:
    out = set()
    pc = 0
    while pc < len(code):
        op = code[pc]
        if op == 0x5B:
            out.add(pc)
        pc += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)
    return out


def _on_g1(p, FQ: int) -> bool:
    x, y = p
    return x < FQ and y < FQ and (y * y - x * x * x - 3) % FQ == 0


def _g1_bytes(p: Optional[tuple]) -> bytes:
    if p is None:
        return b"\x00" * 64
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")
