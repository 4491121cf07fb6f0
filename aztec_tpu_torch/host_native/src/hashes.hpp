// Keccak-256 (legacy 0x01 padding, Ethereum-compatible) and BLAKE2s-256
// (RFC 7693, unkeyed).  Fresh implementations from the public specs for the
// native c_bind layer; byte-compatible with the Python host implementations
// (aztec_tpu_torch/crypto/keccak.py, crypto/blake2s.py = hashlib) and hence with
// the reference's crypto/keccak, crypto/blake2s.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace aztec_tpu {

// ---------------------------- keccak-256 -----------------------------------

inline uint64_t rotl64(uint64_t v, int n) {
    return (v << n) | (v >> (64 - n));
}

inline void keccak_f1600(uint64_t s[25]) {
    static const uint64_t RC[24] = {
        0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
        0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
        0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
        0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
        0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
        0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
        0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
        0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
    };
    // rotation offsets indexed [x][y], state indexed s[x + 5y]
    static const int ROT[5][5] = {
        {0, 36, 3, 41, 18},  {1, 44, 10, 45, 2},  {62, 6, 43, 15, 61},
        {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14},
    };
    for (int round = 0; round < 24; ++round) {
        uint64_t c[5], d[5];
        for (int x = 0; x < 5; ++x)
            c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
        for (int x = 0; x < 5; ++x)
            d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
        for (int x = 0; x < 5; ++x)
            for (int y = 0; y < 5; ++y) s[x + 5 * y] ^= d[x];
        uint64_t b[25];
        for (int x = 0; x < 5; ++x)
            for (int y = 0; y < 5; ++y)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(s[x + 5 * y],
                                                          ROT[x][y]);
        for (int x = 0; x < 5; ++x)
            for (int y = 0; y < 5; ++y)
                s[x + 5 * y] =
                    b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) &
                                    b[(x + 2) % 5 + 5 * y]);
        s[0] ^= RC[round];
    }
}

inline void keccak256(const uint8_t* data, size_t len, uint8_t out[32]) {
    const size_t rate = 136;  // 1088-bit rate
    uint64_t s[25] = {0};
    // absorb full blocks
    while (len >= rate) {
        for (size_t i = 0; i < rate / 8; ++i) {
            uint64_t w;
            std::memcpy(&w, data + 8 * i, 8);  // little-endian host assumed
            s[i] ^= w;
        }
        keccak_f1600(s);
        data += rate;
        len -= rate;
    }
    // final block with 0x01 ... 0x80 padding
    uint8_t block[136] = {0};
    std::memcpy(block, data, len);
    block[len] = 0x01;
    block[rate - 1] |= 0x80;
    for (size_t i = 0; i < rate / 8; ++i) {
        uint64_t w;
        std::memcpy(&w, block + 8 * i, 8);
        s[i] ^= w;
    }
    keccak_f1600(s);
    std::memcpy(out, s, 32);
}

// ---------------------------- blake2s-256 ----------------------------------

inline uint32_t rotr32(uint32_t v, int n) {
    return (v >> n) | (v << (32 - n));
}

inline void blake2s_compress(uint32_t h[8], const uint8_t block[64],
                             uint64_t t, bool last) {
    static const uint32_t IV[8] = {
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    };
    static const uint8_t SIGMA[10][16] = {
        {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
        {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
        {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
        {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
        {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
        {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
        {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
        {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
        {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
        {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    };
    uint32_t m[16], v[16];
    for (int i = 0; i < 16; ++i) std::memcpy(&m[i], block + 4 * i, 4);
    for (int i = 0; i < 8; ++i) v[i] = h[i];
    for (int i = 0; i < 8; ++i) v[8 + i] = IV[i];
    v[12] ^= (uint32_t)t;
    v[13] ^= (uint32_t)(t >> 32);
    if (last) v[14] = ~v[14];

    auto G = [&](int a, int b, int c, int d, uint32_t x, uint32_t y) {
        v[a] = v[a] + v[b] + x;
        v[d] = rotr32(v[d] ^ v[a], 16);
        v[c] = v[c] + v[d];
        v[b] = rotr32(v[b] ^ v[c], 12);
        v[a] = v[a] + v[b] + y;
        v[d] = rotr32(v[d] ^ v[a], 8);
        v[c] = v[c] + v[d];
        v[b] = rotr32(v[b] ^ v[c], 7);
    };
    for (int r = 0; r < 10; ++r) {
        const uint8_t* sg = SIGMA[r];
        G(0, 4, 8, 12, m[sg[0]], m[sg[1]]);
        G(1, 5, 9, 13, m[sg[2]], m[sg[3]]);
        G(2, 6, 10, 14, m[sg[4]], m[sg[5]]);
        G(3, 7, 11, 15, m[sg[6]], m[sg[7]]);
        G(0, 5, 10, 15, m[sg[8]], m[sg[9]]);
        G(1, 6, 11, 12, m[sg[10]], m[sg[11]]);
        G(2, 7, 8, 13, m[sg[12]], m[sg[13]]);
        G(3, 4, 9, 14, m[sg[14]], m[sg[15]]);
    }
    for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[8 + i];
}

inline void blake2s(const uint8_t* data, size_t len, uint8_t out[32]) {
    uint32_t h[8] = {
        0x6A09E667 ^ 0x01010020,  // param block: digest_length=32, fanout=1,
        0xBB67AE85, 0x3C6EF372,   // depth=1 (unkeyed sequential)
        0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    };
    uint64_t t = 0;
    // all blocks but the last
    while (len > 64) {
        t += 64;
        blake2s_compress(h, data, t, false);
        data += 64;
        len -= 64;
    }
    uint8_t block[64] = {0};
    std::memcpy(block, data, len);
    t += len;
    blake2s_compress(h, block, t, true);
    std::memcpy(out, h, 32);
}

}  // namespace aztec_tpu
