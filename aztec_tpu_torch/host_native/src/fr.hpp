// BN254 scalar-field (Fr) Montgomery arithmetic on 4x64-bit limbs.
//
// Fresh implementation for the host-side composer core (standard CIOS
// Montgomery multiplication using __uint128_t); plays the role of the
// reference's ecc/fields/field_impl_generic.hpp on the host, while all bulk
// field math lives in the device kernels (aztec_tpu_torch/ff/).
#pragma once

#include <cstdint>
#include <cstring>

namespace aztec_tpu {

struct fr {
    uint64_t d[4];

    bool operator==(const fr& o) const {
        return d[0] == o.d[0] && d[1] == o.d[1] && d[2] == o.d[2] && d[3] == o.d[3];
    }
};

// r = 21888242871839275222246405745257275088548364400416034343698204186575808495617
static constexpr uint64_t MOD[4] = {
    0x43E1F593F0000001ULL, 0x2833E84879B97091ULL,
    0xB85045B68181585DULL, 0x30644E72E131A029ULL,
};
// -r^{-1} mod 2^64
static constexpr uint64_t R_INV = 0xC2E1F593EFFFFFFFULL;
// R^2 mod r
static constexpr uint64_t R2[4] = {
    0x1BB8E645AE216DA7ULL, 0x53FE3AB1E35C59E3ULL,
    0x8C49833D53BB8085ULL, 0x0216D0B17F4E44A5ULL,
};

inline bool geq_mod(const uint64_t a[4]) {
    for (int i = 3; i >= 0; --i) {
        if (a[i] > MOD[i]) return true;
        if (a[i] < MOD[i]) return false;
    }
    return true;  // equal
}

inline void sub_mod_inplace(uint64_t a[4]) {
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 v = (unsigned __int128)a[i] - MOD[i] - (uint64_t)borrow;
        a[i] = (uint64_t)v;
        borrow = (v >> 64) ? 1 : 0;
    }
}

inline fr add(const fr& a, const fr& b) {
    fr out;
    unsigned __int128 carry = 0;
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 v = (unsigned __int128)a.d[i] + b.d[i] + (uint64_t)carry;
        out.d[i] = (uint64_t)v;
        carry = v >> 64;
    }
    if (carry || geq_mod(out.d)) sub_mod_inplace(out.d);
    return out;
}

inline fr sub(const fr& a, const fr& b) {
    fr out;
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 v = (unsigned __int128)a.d[i] - b.d[i] - (uint64_t)borrow;
        out.d[i] = (uint64_t)v;
        borrow = (v >> 64) ? 1 : 0;
    }
    if (borrow) {
        unsigned __int128 carry = 0;
        for (int i = 0; i < 4; ++i) {
            unsigned __int128 v = (unsigned __int128)out.d[i] + MOD[i] + (uint64_t)carry;
            out.d[i] = (uint64_t)v;
            carry = v >> 64;
        }
    }
    return out;
}

// CIOS Montgomery multiplication.
inline fr mont_mul(const fr& a, const fr& b) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 c = 0;
        for (int j = 0; j < 4; ++j) {
            unsigned __int128 v = (unsigned __int128)a.d[j] * b.d[i] + t[j] + (uint64_t)c;
            t[j] = (uint64_t)v;
            c = v >> 64;
        }
        unsigned __int128 v = (unsigned __int128)t[4] + (uint64_t)c;
        t[4] = (uint64_t)v;
        t[5] = (uint64_t)(v >> 64);

        uint64_t m = t[0] * R_INV;
        c = ((unsigned __int128)m * MOD[0] + t[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            unsigned __int128 u = (unsigned __int128)m * MOD[j] + t[j] + (uint64_t)c;
            t[j - 1] = (uint64_t)u;
            c = u >> 64;
        }
        v = (unsigned __int128)t[4] + (uint64_t)c;
        t[3] = (uint64_t)v;
        t[4] = t[5] + (uint64_t)(v >> 64);
    }
    fr out;
    std::memcpy(out.d, t, 32);
    if (t[4] || geq_mod(out.d)) sub_mod_inplace(out.d);
    return out;
}

inline fr to_mont(const fr& a) {
    fr r2;
    std::memcpy(r2.d, R2, 32);
    return mont_mul(a, r2);
}

inline fr from_mont(const fr& a) {
    fr one = {{1, 0, 0, 0}};
    return mont_mul(a, one);
}

inline fr zero() { return fr{{0, 0, 0, 0}}; }

inline fr neg(const fr& a) {
    fr z = zero();
    return sub(z, a);
}

}  // namespace aztec_tpu
