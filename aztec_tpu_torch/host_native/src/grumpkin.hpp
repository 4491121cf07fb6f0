// Grumpkin curve + Pedersen hash + Schnorr, native host implementation.
//
// Mirrors the framework's Python host layer (aztec_tpu_torch/crypto/pedersen.py,
// crypto/schnorr.py) bit-for-bit, which in turn matches the reference
// (crypto/pedersen/pedersen.cpp, ecc/groups/wnaf.hpp fixed_wnaf,
// affine_element_impl.hpp hash_to_curve, crypto/schnorr/schnorr.tcc).
// Serves the sequencer/SDK hashing hot paths through the flat c_bind ABI;
// bulk Merkle hashing stays on the device (crypto/pedersen_device.py).
//
// Grumpkin: y^2 = x^3 - 17 over Fq = bn254-Fr; group order = bn254-Fq.
#pragma once

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include "field256.hpp"
#include "hashes.hpp"

namespace aztec_tpu {
namespace grumpkin {

constexpr int QUAD_LENGTH = 129;
constexpr int NUM_QUADS = 127;
constexpr int NUM_BITS = 254;

// ---- point types -----------------------------------------------------------

struct APoint {  // affine, coordinates in Montgomery form
    Fr x, y;
    bool inf;
};

struct JPoint {  // Jacobian; Z == 0 encodes infinity
    Fr X, Y, Z;
};

inline Fr curve_b() {
    // -17 mod p, Montgomery form
    Fr seventeen{{17, 0, 0, 0}};
    return fp_neg(fp_to_mont(seventeen));
}

inline APoint a_infinity() { return APoint{fp_zero<FrParams>(), fp_zero<FrParams>(), true}; }

inline APoint a_neg(const APoint& a) {
    if (a.inf) return a;
    return APoint{a.x, fp_neg(a.y), false};
}

inline bool on_curve(const APoint& a) {
    if (a.inf) return true;
    Fr lhs = fp_sqr(a.y);
    Fr rhs = fp_add(fp_mul(fp_sqr(a.x), a.x), curve_b());
    return lhs == rhs;
}

// ---- affine ops (inversion-based; ladder/generator construction only) ------

inline APoint a_dbl(const APoint& a) {
    if (a.inf || a.y.is_zero()) return a_infinity();
    Fr x2 = fp_sqr(a.x);
    Fr num = fp_add(fp_add(x2, x2), x2);          // 3x^2
    Fr den = fp_inv(fp_add(a.y, a.y));            // (2y)^-1
    Fr lam = fp_mul(num, den);
    Fr x3 = fp_sub(fp_sqr(lam), fp_add(a.x, a.x));
    Fr y3 = fp_sub(fp_mul(lam, fp_sub(a.x, x3)), a.y);
    return APoint{x3, y3, false};
}

inline APoint a_add(const APoint& a, const APoint& b) {
    if (a.inf) return b;
    if (b.inf) return a;
    if (a.x == b.x) {
        if (fp_add(a.y, b.y).is_zero()) return a_infinity();
        return a_dbl(a);
    }
    Fr lam = fp_mul(fp_sub(b.y, a.y), fp_inv(fp_sub(b.x, a.x)));
    Fr x3 = fp_sub(fp_sqr(lam), fp_add(a.x, b.x));
    Fr y3 = fp_sub(fp_mul(lam, fp_sub(a.x, x3)), a.y);
    return APoint{x3, y3, false};
}

// ---- Jacobian ops (hash/scalar-mul accumulation hot path) ------------------

inline JPoint j_infinity() {
    return JPoint{fp_zero<FrParams>(), fp_zero<FrParams>(), fp_zero<FrParams>()};
}

inline JPoint j_from_affine(const APoint& a) {
    if (a.inf) return j_infinity();
    return JPoint{a.x, a.y, fp_one_mont<FrParams>()};
}

inline JPoint j_dbl(const JPoint& p) {
    if (p.Z.is_zero() || p.Y.is_zero()) return j_infinity();
    Fr A = fp_sqr(p.X);
    Fr B = fp_sqr(p.Y);
    Fr C = fp_sqr(B);
    Fr D = fp_sub(fp_sqr(fp_add(p.X, B)), fp_add(A, C));
    D = fp_add(D, D);
    Fr E = fp_add(fp_add(A, A), A);
    Fr F = fp_sqr(E);
    Fr X3 = fp_sub(F, fp_add(D, D));
    Fr C8 = fp_add(C, C);
    C8 = fp_add(C8, C8);
    C8 = fp_add(C8, C8);
    Fr Y3 = fp_sub(fp_mul(E, fp_sub(D, X3)), C8);
    Fr Z3 = fp_mul(p.Y, p.Z);
    Z3 = fp_add(Z3, Z3);
    return JPoint{X3, Y3, Z3};
}

inline JPoint j_mixed_add(const JPoint& p, const APoint& q) {
    if (q.inf) return p;
    if (p.Z.is_zero()) return j_from_affine(q);
    Fr Z1Z1 = fp_sqr(p.Z);
    Fr U2 = fp_mul(q.x, Z1Z1);
    Fr S2 = fp_mul(fp_mul(q.y, p.Z), Z1Z1);
    Fr H = fp_sub(U2, p.X);
    Fr rr = fp_sub(S2, p.Y);
    rr = fp_add(rr, rr);
    if (H.is_zero()) {
        if (rr.is_zero()) return j_dbl(p);
        return j_infinity();
    }
    Fr HH = fp_sqr(H);
    Fr I = fp_add(HH, HH);
    I = fp_add(I, I);
    Fr J = fp_mul(H, I);
    Fr V = fp_mul(p.X, I);
    Fr X3 = fp_sub(fp_sqr(rr), fp_add(J, fp_add(V, V)));
    Fr YJ = fp_mul(p.Y, J);
    Fr Y3 = fp_sub(fp_mul(rr, fp_sub(V, X3)), fp_add(YJ, YJ));
    Fr Z3 = fp_sub(fp_sqr(fp_add(p.Z, H)), fp_add(Z1Z1, HH));
    return JPoint{X3, Y3, Z3};
}

inline APoint j_to_affine(const JPoint& p) {
    if (p.Z.is_zero()) return a_infinity();
    Fr zi = fp_inv(p.Z);
    Fr zi2 = fp_sqr(zi);
    return APoint{fp_mul(p.X, zi2), fp_mul(p.Y, fp_mul(zi2, zi)), false};
}

// ---- sqrt (Tonelli-Shanks; p % 4 == 1, s = 28) -----------------------------

inline bool fr_sqrt(const Fr& v, Fr* out) {
    if (v.is_zero()) {
        *out = v;
        return true;
    }
    static const uint64_t LEGENDRE_EXP[4] = {  // (p-1)/2
        0xA1F0FAC9F8000000ULL, 0x9419F4243CDCB848ULL,
        0xDC2822DB40C0AC2EULL, 0x183227397098D014ULL,
    };
    static const uint64_t Q_EXP[4] = {  // q where p-1 = q * 2^28
        0x9B9709143E1F593FULL, 0x181585D2833E8487ULL,
        0x131A029B85045B68ULL, 0x000000030644E72EULL,
    };
    static const uint64_t Q1H_EXP[4] = {  // (q+1)/2
        0xCDCB848A1F0FACA0ULL, 0x0C0AC2E9419F4243ULL,
        0x098D014DC2822DB4ULL, 0x0000000183227397ULL,
    };
    Fr one = fp_one_mont<FrParams>();
    if (!(fp_pow(v, LEGENDRE_EXP) == one)) return false;
    // z = 5: the field's multiplicative generator, a known non-residue
    // (crypto/pedersen.py _sqrt)
    Fr z = fp_to_mont(Fr{{5, 0, 0, 0}});
    int m = 28;
    Fr c = fp_pow(z, Q_EXP);
    Fr t = fp_pow(v, Q_EXP);
    Fr r = fp_pow(v, Q1H_EXP);
    while (!(t == one)) {
        Fr t2 = t;
        int i = 0;
        while (!(t2 == one)) {
            t2 = fp_sqr(t2);
            ++i;
        }
        Fr b = c;
        for (int k = 0; k < m - i - 1; ++k) b = fp_sqr(b);
        m = i;
        c = fp_sqr(b);
        t = fp_mul(t, c);
        r = fp_mul(r, b);
    }
    *out = r;
    return true;
}

// ---- hash_to_curve generator stream ---------------------------------------

// canonical (non-Montgomery) parity of a field element
inline bool fr_is_odd_canonical(const Fr& a) {
    Fr c = fp_from_mont(a);
    return c.d[0] & 1;
}

inline bool hash_to_curve(uint64_t seed, APoint* out) {
    uint8_t data[32] = {0};
    for (int i = 0; i < 8; ++i) data[i] = (uint8_t)(seed >> (8 * (7 - i)));
    uint8_t h[32];
    keccak256(data, 32, h);
    // words little-endian per 8-byte chunk; word k occupies bits [64k, 64k+64)
    uint64_t w[4];
    std::memcpy(w, h, 32);
    bool y_bit = (w[3] >> 63) & 1;
    w[3] &= ~(1ULL << 63);
    Fr raw{{w[0], w[1], w[2], w[3]}};
    while (fp_geq_mod<FrParams>(raw.d)) fp_sub_mod_inplace<FrParams>(raw.d);
    Fr x = fp_to_mont(raw);
    Fr y2 = fp_add(fp_mul(fp_sqr(x), x), curve_b());
    Fr y;
    if (!fr_sqrt(y2, &y)) return false;
    if (fr_is_odd_canonical(y) != y_bit) y = fp_neg(y);
    *out = APoint{x, y, false};
    return true;
}

inline APoint grumpkin_one() {
    // (1, 0x2CF135E7506A45D632D270D45F1181294833FC48D823F272C)
    // (ecc/curves/grumpkin/grumpkin.hpp one_x/one_y)
    Fr gx = fp_to_mont(Fr{{1, 0, 0, 0}});
    Fr gy = fp_to_mont(Fr{{0x833FC48D823F272CULL, 0x2D270D45F1181294ULL,
                           0xCF135E7506A45D63ULL, 0x0000000000000002ULL}});
    return APoint{gx, gy, false};
}

struct GeneratorCtx {
    std::vector<APoint> generators;
    uint64_t next_seed = 1;
    std::mutex mu;

    const APoint& get(size_t index) {
        std::lock_guard<std::mutex> lock(mu);
        while (generators.size() <= index) {
            APoint cand;
            if (hash_to_curve(next_seed++, &cand) && on_curve(cand)) {
                generators.push_back(cand);
            }
        }
        return generators[index];
    }
};

inline GeneratorCtx& generator_ctx() {
    static GeneratorCtx ctx;
    return ctx;
}

// ---- ladders ---------------------------------------------------------------

struct LadderEntry {
    APoint one, three;
};

using Ladder = std::vector<LadderEntry>;  // QUAD_LENGTH entries, MSB-first

inline Ladder ladder_from_point(const APoint& pt) {
    APoint acc = pt;
    std::vector<APoint> ones, threes;
    ones.reserve(QUAD_LENGTH);
    threes.reserve(QUAD_LENGTH);
    for (int i = 0; i < QUAD_LENGTH; ++i) {
        ones.push_back(acc);
        acc = a_dbl(acc);
        threes.push_back(a_add(ones.back(), acc));
        acc = a_dbl(acc);
    }
    Ladder out(QUAD_LENGTH);
    for (int i = 0; i < QUAD_LENGTH; ++i) {
        out[i] = LadderEntry{ones[QUAD_LENGTH - 1 - i],
                             threes[QUAD_LENGTH - 1 - i]};
    }
    return out;
}

struct LadderCache {
    std::vector<Ladder> ladders;       // per generator index
    std::vector<Ladder> hash_ladders;  // per hash index (stitched)
    Ladder g1;
    bool g1_built = false;
    std::mutex mu;

    const Ladder& get(size_t generator_index) {
        std::lock_guard<std::mutex> lock(mu);
        while (ladders.size() <= generator_index) {
            ladders.push_back(
                ladder_from_point(generator_ctx().get(ladders.size())));
        }
        return ladders[generator_index];
    }

    // 127 high quads from generator 2i + 2 low quads from generator 2i+1
    // (pedersen.cpp:91-104)
    const Ladder& get_hash(size_t hash_index) {
        get(2 * hash_index + 1);  // populate deps outside the lock below
        std::lock_guard<std::mutex> lock(mu);
        while (hash_ladders.size() <= hash_index) {
            size_t i = hash_ladders.size();
            const Ladder& a = ladders[2 * i];
            const Ladder& b = ladders[2 * i + 1];
            Ladder h(QUAD_LENGTH);
            const int first_seg = QUAD_LENGTH - 2;
            for (int j = 0; j < first_seg; ++j)
                h[j] = a[j + (QUAD_LENGTH - first_seg)];
            for (int j = 0; j < 2; ++j)
                h[first_seg + j] = b[j + (QUAD_LENGTH - 2)];
            hash_ladders.push_back(std::move(h));
        }
        return hash_ladders[hash_index];
    }

    const Ladder& get_g1() {
        std::lock_guard<std::mutex> lock(mu);
        if (!g1_built) {
            g1 = ladder_from_point(grumpkin_one());
            g1_built = true;
        }
        return g1;
    }
};

inline LadderCache& ladder_cache() {
    static LadderCache cache;
    return cache;
}

// ---- fixed 2-bit WNAF (ecc/groups/wnaf.hpp:163-191) ------------------------

// scalar: canonical 4x64 little-endian words
inline uint64_t u256_slice2(const uint64_t s[4], int pos) {
    return (s[pos / 64] >> (pos % 64)) & 3;  // 2-bit aligned, never straddles
}

inline void fixed_wnaf2(const uint64_t scalar[4], int num_bits,
                        uint64_t* wnaf /* entries_n */, bool* skew) {
    const int entries_n = (num_bits + 1) / 2;
    *skew = (scalar[0] & 1) == 0;
    uint64_t previous = (scalar[0] & 3) + (*skew ? 1 : 0);
    for (int round_i = 1; round_i < entries_n - 1; ++round_i) {
        uint64_t slice = u256_slice2(scalar, round_i * 2);
        uint64_t predicate = ((slice & 1) == 0) ? 1 : 0;
        uint64_t v = previous - (predicate << 2);
        if (predicate) v = ~v;
        wnaf[entries_n - round_i] = (v >> 1) | (predicate << 31);
        previous = slice + predicate;
    }
    const int final_bits = num_bits - 2 * (entries_n - 1);
    uint64_t slice = (scalar[(2 * (entries_n - 1)) / 64] >>
                      ((2 * (entries_n - 1)) % 64)) &
                     ((1ULL << final_bits) - 1);
    uint64_t predicate = ((slice & 1) == 0) ? 1 : 0;
    uint64_t v = previous - (predicate << 2);
    if (predicate) v = ~v;
    wnaf[1] = (v >> 1) | (predicate << 31);
    wnaf[0] = (slice + predicate) >> 1;
}

// value (canonical) -> base = value if odd else value - 2 (mod p)
inline void wnaf_base(const Fr& value_canonical, uint64_t base[4]) {
    std::memcpy(base, value_canonical.d, 32);
    if ((base[0] & 1) == 0) {
        // base -= 2 mod p
        uint64_t borrow = (base[0] < 2);
        base[0] -= 2;
        for (int i = 1; i < 4 && borrow; ++i) {
            borrow = (base[i] == 0);
            base[i] -= 1;
        }
        if (borrow) {  // wrapped below zero: add p
            unsigned __int128 carry = 0;
            for (int i = 0; i < 4; ++i) {
                unsigned __int128 v = (unsigned __int128)base[i] +
                                      FrParams::MOD[i] + (uint64_t)carry;
                base[i] = (uint64_t)v;
                carry = v >> 64;
            }
        }
    }
}

// ---- ladder walks (pedersen.hpp:44-80 / pedersen.cpp:230-272) --------------

inline int num_quads_for(int num_bits) {
    int base = (num_bits - 1) >> 1;
    return ((base << 1) + 1 < num_bits) ? base + 1 : base;
}

// Shared fixed-base ladder walk.  value_canonical: canonical Fr.
inline APoint ladder_mul(const Fr& value_canonical, int num_bits,
                         const Ladder& full_ladder, const APoint& skew_point) {
    const int n = num_quads_for(num_bits);
    const LadderEntry* ladder = full_ladder.data() + (QUAD_LENGTH - n - 1);
    uint64_t base[4];
    wnaf_base(value_canonical, base);
    std::vector<uint64_t> wnaf(n + 1);
    bool skew;
    fixed_wnaf2(base, (n << 1) + 1, wnaf.data(), &skew);
    JPoint acc = j_from_affine(ladder[0].one);
    if (skew) acc = j_mixed_add(acc, skew_point);
    for (int i = 0; i < n; ++i) {
        uint64_t entry = wnaf[i + 1];
        APoint pt = ((entry & 0xFFFFFF) == 1) ? ladder[i + 1].three
                                              : ladder[i + 1].one;
        if ((entry >> 31) & 1) pt = a_neg(pt);
        acc = j_mixed_add(acc, pt);
    }
    return j_to_affine(acc);
}

// hash_single (pedersen.cpp:230-272); value canonical (Montgomery NOT
// applied).  Returns infinity for value == 0.
inline APoint hash_single(const Fr& value_canonical, size_t hash_index) {
    const Ladder& hl = ladder_cache().get_hash(hash_index);
    const LadderEntry* ladder = hl.data() + (QUAD_LENGTH - NUM_QUADS - 1);
    uint64_t base[4];
    wnaf_base(value_canonical, base);
    uint64_t wnaf[NUM_QUADS + 1];
    bool skew;
    fixed_wnaf2(base, 2 * NUM_QUADS + 1, wnaf, &skew);
    JPoint acc = j_from_affine(ladder[0].one);
    if (skew)
        acc = j_mixed_add(acc, generator_ctx().get(hash_index * 2 + 1));
    for (int i = 0; i < NUM_QUADS; ++i) {
        uint64_t entry = wnaf[i + 1];
        APoint pt = ((entry & 0xFFFFFF) == 1) ? ladder[i + 1].three
                                              : ladder[i + 1].one;
        if ((entry >> 31) & 1) pt = a_neg(pt);
        acc = j_mixed_add(acc, pt);
    }
    if (value_canonical.is_zero()) return a_infinity();
    return j_to_affine(acc);
}

// encrypt_native / compress (pedersen.cpp:274-299)
inline APoint encrypt_native(const Fr* values_canonical, size_t n,
                             size_t hash_index) {
    JPoint acc = j_infinity();
    for (size_t i = 0; i < n; ++i) {
        APoint h = hash_single(values_canonical[i], hash_index + i);
        acc = j_mixed_add(acc, h);
    }
    return j_to_affine(acc);  // infinity -> (0, 0) handled by caller
}

// 31-byte big-endian chunks -> compress (pedersen.cpp
// compress_native_buffer_to_field)
inline Fr compress_buffer_to_field(const uint8_t* data, size_t len,
                                   APoint* out_pt) {
    std::vector<Fr> elems;
    for (size_t i = 0; i < len; i += 31) {
        size_t chunk = (len - i < 31) ? (len - i) : 31;
        uint8_t be[32] = {0};
        std::memcpy(be + (32 - chunk), data + i, chunk);
        Fr raw{{0, 0, 0, 0}};
        for (int k = 0; k < 4; ++k) {
            uint64_t w = 0;
            for (int j = 0; j < 8; ++j) w = (w << 8) | be[k * 8 + j];
            raw.d[3 - k] = w;
        }
        while (fp_geq_mod<FrParams>(raw.d)) fp_sub_mod_inplace<FrParams>(raw.d);
        elems.push_back(raw);
    }
    APoint r = encrypt_native(elems.data(), elems.size(), 0);
    if (out_pt) *out_pt = r;
    return r.inf ? fp_zero<FrParams>() : fp_from_mont(r.x);
}

// ---- generic scalar mul (schnorr) ------------------------------------------

// k: canonical 4x64 little-endian; simple double-and-add MSB-first.
inline APoint scalar_mul(const uint64_t k[4], const APoint& base) {
    JPoint acc = j_infinity();
    bool started = false;
    for (int w = 3; w >= 0; --w) {
        for (int b = 63; b >= 0; --b) {
            if (started) acc = j_dbl(acc);
            if ((k[w] >> b) & 1) {
                acc = j_mixed_add(acc, base);
                started = true;
            }
        }
    }
    return j_to_affine(acc);
}

}  // namespace grumpkin
}  // namespace aztec_tpu
