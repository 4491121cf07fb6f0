// Generic 256-bit prime-field Montgomery arithmetic on 4x64-bit limbs,
// parameterized by a constants struct (modulus, -p^-1 mod 2^64, R^2).
//
// Fresh implementation for the native c_bind layer (role of the reference's
// ecc/fields/field_impl_generic.hpp on the host): the framework's bulk field
// math runs in the device kernels (aztec_tpu_torch/ff/); this serves
// the host-side crypto primitives (pedersen/schnorr over grumpkin) where
// per-element latency, not throughput, matters.
#pragma once

#include <cstdint>
#include <cstring>

namespace aztec_tpu {

// BN254 Fr = grumpkin coordinate field.
struct FrParams {
    static constexpr uint64_t MOD[4] = {
        0x43E1F593F0000001ULL, 0x2833E84879B97091ULL,
        0xB85045B68181585DULL, 0x30644E72E131A029ULL,
    };
    static constexpr uint64_t R_INV = 0xC2E1F593EFFFFFFFULL;
    static constexpr uint64_t R2[4] = {
        0x1BB8E645AE216DA7ULL, 0x53FE3AB1E35C59E3ULL,
        0x8C49833D53BB8085ULL, 0x0216D0B17F4E44A5ULL,
    };
};

// BN254 Fq = grumpkin group order (schnorr scalar field).
struct FqParams {
    static constexpr uint64_t MOD[4] = {
        0x3C208C16D87CFD47ULL, 0x97816A916871CA8DULL,
        0xB85045B68181585DULL, 0x30644E72E131A029ULL,
    };
    static constexpr uint64_t R_INV = 0x87D20782E4866389ULL;
    static constexpr uint64_t R2[4] = {
        0xF32CFC5B538AFA89ULL, 0xB5E71911D44501FBULL,
        0x47AB1EFF0A417FF6ULL, 0x06D89F71CAB8351FULL,
    };
};

template <typename P> struct Fp {
    uint64_t d[4];

    bool operator==(const Fp& o) const {
        return d[0] == o.d[0] && d[1] == o.d[1] && d[2] == o.d[2] &&
               d[3] == o.d[3];
    }
    bool is_zero() const { return !(d[0] | d[1] | d[2] | d[3]); }
};

template <typename P> inline bool fp_geq_mod(const uint64_t a[4]) {
    for (int i = 3; i >= 0; --i) {
        if (a[i] > P::MOD[i]) return true;
        if (a[i] < P::MOD[i]) return false;
    }
    return true;
}

template <typename P> inline void fp_sub_mod_inplace(uint64_t a[4]) {
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 v =
            (unsigned __int128)a[i] - P::MOD[i] - (uint64_t)borrow;
        a[i] = (uint64_t)v;
        borrow = (v >> 64) ? 1 : 0;
    }
}

template <typename P> inline Fp<P> fp_add(const Fp<P>& a, const Fp<P>& b) {
    Fp<P> out;
    unsigned __int128 carry = 0;
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 v =
            (unsigned __int128)a.d[i] + b.d[i] + (uint64_t)carry;
        out.d[i] = (uint64_t)v;
        carry = v >> 64;
    }
    if (carry || fp_geq_mod<P>(out.d)) fp_sub_mod_inplace<P>(out.d);
    return out;
}

template <typename P> inline Fp<P> fp_sub(const Fp<P>& a, const Fp<P>& b) {
    Fp<P> out;
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 v =
            (unsigned __int128)a.d[i] - b.d[i] - (uint64_t)borrow;
        out.d[i] = (uint64_t)v;
        borrow = (v >> 64) ? 1 : 0;
    }
    if (borrow) {
        unsigned __int128 carry = 0;
        for (int i = 0; i < 4; ++i) {
            unsigned __int128 v =
                (unsigned __int128)out.d[i] + P::MOD[i] + (uint64_t)carry;
            out.d[i] = (uint64_t)v;
            carry = v >> 64;
        }
    }
    return out;
}

// CIOS Montgomery multiplication.
template <typename P> inline Fp<P> fp_mul(const Fp<P>& a, const Fp<P>& b) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 c = 0;
        for (int j = 0; j < 4; ++j) {
            unsigned __int128 v =
                (unsigned __int128)a.d[j] * b.d[i] + t[j] + (uint64_t)c;
            t[j] = (uint64_t)v;
            c = v >> 64;
        }
        unsigned __int128 v = (unsigned __int128)t[4] + (uint64_t)c;
        t[4] = (uint64_t)v;
        t[5] = (uint64_t)(v >> 64);

        uint64_t m = t[0] * P::R_INV;
        c = ((unsigned __int128)m * P::MOD[0] + t[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            unsigned __int128 u =
                (unsigned __int128)m * P::MOD[j] + t[j] + (uint64_t)c;
            t[j - 1] = (uint64_t)u;
            c = u >> 64;
        }
        v = (unsigned __int128)t[4] + (uint64_t)c;
        t[3] = (uint64_t)v;
        t[4] = t[5] + (uint64_t)(v >> 64);
    }
    Fp<P> out;
    std::memcpy(out.d, t, 32);
    if (t[4] || fp_geq_mod<P>(out.d)) fp_sub_mod_inplace<P>(out.d);
    return out;
}

template <typename P> inline Fp<P> fp_sqr(const Fp<P>& a) {
    return fp_mul(a, a);
}

template <typename P> inline Fp<P> fp_zero() { return Fp<P>{{0, 0, 0, 0}}; }

template <typename P> inline Fp<P> fp_one_mont() {
    // R mod p = REDC(R^2 * 1)
    Fp<P> one{{1, 0, 0, 0}};
    Fp<P> r2;
    std::memcpy(r2.d, P::R2, 32);
    return fp_mul(one, r2);
}

template <typename P> inline Fp<P> fp_to_mont(const Fp<P>& a) {
    Fp<P> r2;
    std::memcpy(r2.d, P::R2, 32);
    return fp_mul(a, r2);
}

template <typename P> inline Fp<P> fp_from_mont(const Fp<P>& a) {
    Fp<P> one{{1, 0, 0, 0}};
    return fp_mul(a, one);
}

template <typename P> inline Fp<P> fp_neg(const Fp<P>& a) {
    return fp_sub(fp_zero<P>(), a);
}

// a^e (Montgomery in/out), e given as 4x64 little-endian words.
template <typename P>
inline Fp<P> fp_pow(const Fp<P>& a, const uint64_t e[4]) {
    Fp<P> result = fp_one_mont<P>();
    Fp<P> base = a;
    for (int w = 0; w < 4; ++w) {
        uint64_t bits = e[w];
        for (int i = 0; i < 64; ++i) {
            if (bits & 1) result = fp_mul(result, base);
            base = fp_sqr(base);
            bits >>= 1;
        }
    }
    return result;
}

// Fermat inversion (Montgomery in/out); 0 -> 0.
template <typename P> inline Fp<P> fp_inv(const Fp<P>& a) {
    uint64_t pm2[4];
    std::memcpy(pm2, P::MOD, 32);
    uint64_t borrow = (pm2[0] < 2);
    pm2[0] -= 2;
    for (int i = 1; i < 4 && borrow; ++i) {
        borrow = (pm2[i] == 0);
        pm2[i] -= 1;
    }
    return fp_pow(a, pm2);
}

// ---- byte I/O: 32-byte big-endian (the wire convention, plonk/serialize.py)

template <typename P> inline Fp<P> fp_from_be_bytes(const uint8_t* in) {
    Fp<P> raw{{0, 0, 0, 0}};
    for (int i = 0; i < 4; ++i) {
        uint64_t w = 0;
        for (int j = 0; j < 8; ++j) w = (w << 8) | in[i * 8 + j];
        raw.d[3 - i] = w;
    }
    while (fp_geq_mod<P>(raw.d)) fp_sub_mod_inplace<P>(raw.d);
    return fp_to_mont(raw);
}

template <typename P> inline void fp_to_be_bytes(const Fp<P>& a, uint8_t* out) {
    Fp<P> v = fp_from_mont(a);
    for (int i = 0; i < 4; ++i) {
        uint64_t w = v.d[3 - i];
        for (int j = 7; j >= 0; --j) {
            out[i * 8 + j] = (uint8_t)(w & 0xFF);
            w >>= 8;
        }
    }
}

using Fr = Fp<FrParams>;
using FqOrd = Fp<FqParams>;

}  // namespace aztec_tpu
