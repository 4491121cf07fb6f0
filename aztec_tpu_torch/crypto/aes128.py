"""AES-128 (CBC) — pure-Python host implementation (ref: crypto/aes128/).

Used by the SDK layer for note encryption; throughput is irrelevant
(32-byte notes), correctness is what matters.  Standard FIPS-197 tables.

Port of aztec_tpu/crypto/aes128.py: the same tables and CBC, line for line.
"""

from __future__ import annotations

_SBOX = None
_INV_SBOX = None


def _build_tables():
    global _SBOX, _INV_SBOX
    if _SBOX is not None:
        return
    # generate the S-box from the finite-field inverse + affine transform
    def xtime(a):
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        return a & 0xFF

    # multiplicative inverse via log tables over GF(2^8), generator 3
    log = [0] * 256
    alog = [0] * 256
    x = 1
    for i in range(255):
        alog[i] = x
        log[x] = i
        x ^= xtime(x)
    def inv(a):
        return 0 if a == 0 else alog[(255 - log[a]) % 255]

    sbox = []
    for i in range(256):
        c = inv(i)
        r = 0
        for k in range(8):
            bit = (
                (c >> k) ^ (c >> ((k + 4) % 8)) ^ (c >> ((k + 5) % 8))
                ^ (c >> ((k + 6) % 8)) ^ (c >> ((k + 7) % 8)) ^ (0x63 >> k)
            ) & 1
            r |= bit << k
        sbox.append(r)
    _SBOX = sbox
    _INV_SBOX = [0] * 256
    for i, v in enumerate(sbox):
        _INV_SBOX[v] = i


def _gmul(a, b):
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return r


def _expand_key(key: bytes):
    _build_tables()
    assert len(key) == 16
    w = [list(key[4 * i : 4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [_SBOX[t[1]], _SBOX[t[2]], _SBOX[t[3]], _SBOX[t[0]]]
            t[0] ^= rcon
            rcon = _gmul(rcon, 2)
        w.append([w[i - 4][k] ^ t[k] for k in range(4)])
    return w


def _encrypt_block(block: bytes, w) -> bytes:
    s = [[block[r + 4 * c] for c in range(4)] for r in range(4)]

    def add_round_key(rnd):
        for c in range(4):
            for r in range(4):
                s[r][c] ^= w[4 * rnd + c][r]

    add_round_key(0)
    for rnd in range(1, 11):
        for r in range(4):
            for c in range(4):
                s[r][c] = _SBOX[s[r][c]]
        for r in range(1, 4):
            s[r] = s[r][r:] + s[r][:r]
        if rnd != 10:
            for c in range(4):
                a = [s[r][c] for r in range(4)]
                s[0][c] = _gmul(a[0], 2) ^ _gmul(a[1], 3) ^ a[2] ^ a[3]
                s[1][c] = a[0] ^ _gmul(a[1], 2) ^ _gmul(a[2], 3) ^ a[3]
                s[2][c] = a[0] ^ a[1] ^ _gmul(a[2], 2) ^ _gmul(a[3], 3)
                s[3][c] = _gmul(a[0], 3) ^ a[1] ^ a[2] ^ _gmul(a[3], 2)
        add_round_key(rnd)
    return bytes(s[r][c] for c in range(4) for r in range(4))


def _decrypt_block(block: bytes, w) -> bytes:
    s = [[block[r + 4 * c] for c in range(4)] for r in range(4)]

    def add_round_key(rnd):
        for c in range(4):
            for r in range(4):
                s[r][c] ^= w[4 * rnd + c][r]

    add_round_key(10)
    for rnd in range(9, -1, -1):
        for r in range(1, 4):
            s[r] = s[r][-r:] + s[r][:-r]
        for r in range(4):
            for c in range(4):
                s[r][c] = _INV_SBOX[s[r][c]]
        add_round_key(rnd)
        if rnd != 0:
            for c in range(4):
                a = [s[r][c] for r in range(4)]
                s[0][c] = _gmul(a[0], 14) ^ _gmul(a[1], 11) ^ _gmul(a[2], 13) ^ _gmul(a[3], 9)
                s[1][c] = _gmul(a[0], 9) ^ _gmul(a[1], 14) ^ _gmul(a[2], 11) ^ _gmul(a[3], 13)
                s[2][c] = _gmul(a[0], 13) ^ _gmul(a[1], 9) ^ _gmul(a[2], 14) ^ _gmul(a[3], 11)
                s[3][c] = _gmul(a[0], 11) ^ _gmul(a[1], 13) ^ _gmul(a[2], 9) ^ _gmul(a[3], 14)
    return bytes(s[r][c] for c in range(4) for r in range(4))


def encrypt_cbc(plaintext: bytes, key: bytes, iv: bytes) -> bytes:
    assert len(plaintext) % 16 == 0 and len(iv) == 16
    w = _expand_key(key)
    out = b""
    prev = iv
    for i in range(0, len(plaintext), 16):
        blk = bytes(x ^ y for x, y in zip(plaintext[i : i + 16], prev))
        prev = _encrypt_block(blk, w)
        out += prev
    return out


def decrypt_cbc(ciphertext: bytes, key: bytes, iv: bytes) -> bytes:
    assert len(ciphertext) % 16 == 0 and len(iv) == 16
    w = _expand_key(key)
    out = b""
    prev = iv
    for i in range(0, len(ciphertext), 16):
        blk = ciphertext[i : i + 16]
        out += bytes(x ^ y for x, y in zip(_decrypt_block(blk, w), prev))
        prev = blk
    return out
