// Flat C ABI over the native host crypto — the framework's equivalent of the
// reference's c_bind layer (crypto/pedersen/c_bind.cpp, crypto/blake2s/c_bind.cpp,
// crypto/schnorr/c_bind.cpp): byte-buffer in/out, no C++ types across the
// boundary, loadable via ctypes (host_native/cbind.py).
//
// Wire conventions (plonk/serialize.py): field elements are 32-byte
// big-endian; affine points are x||y (64 bytes); the point at infinity
// serializes as all-zero.  Proof construction is NOT exposed here — proving
// is a device workload dispatched through the serving worker protocol
// (serving/proof_worker.py), which plays the role of the reference's
// plonk/proof_system/prover/c_bind.cpp for this framework.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#include "field256.hpp"
#include "grumpkin.hpp"
#include "hashes.hpp"

using namespace aztec_tpu;
using namespace aztec_tpu::grumpkin;

namespace {

// 32-byte big-endian -> canonical residue (NOT Montgomery)
template <typename P>
Fp<P> raw_from_be(const uint8_t* in, bool* overflowed = nullptr) {
    Fp<P> raw{{0, 0, 0, 0}};
    for (int i = 0; i < 4; ++i) {
        uint64_t w = 0;
        for (int j = 0; j < 8; ++j) w = (w << 8) | in[i * 8 + j];
        raw.d[3 - i] = w;
    }
    bool over = fp_geq_mod<P>(raw.d);
    if (overflowed) *overflowed = over;
    while (fp_geq_mod<P>(raw.d)) fp_sub_mod_inplace<P>(raw.d);
    return raw;
}

template <typename P>
void raw_to_be(const Fp<P>& canonical, uint8_t* out) {
    for (int i = 0; i < 4; ++i) {
        uint64_t w = canonical.d[3 - i];
        for (int j = 7; j >= 0; --j) {
            out[i * 8 + j] = (uint8_t)(w & 0xFF);
            w >>= 8;
        }
    }
}

void write_point(const APoint& p, uint8_t* out64) {
    if (p.inf) {
        std::memset(out64, 0, 64);
        return;
    }
    fp_to_be_bytes(p.x, out64);
    fp_to_be_bytes(p.y, out64 + 32);
}

bool read_point(const uint8_t* in64, APoint* out) {
    bool over_x = false, over_y = false;
    Fr x = raw_from_be<FrParams>(in64, &over_x);
    Fr y = raw_from_be<FrParams>(in64 + 32, &over_y);
    if (over_x || over_y) return false;
    if (x.is_zero() && y.is_zero()) {
        *out = a_infinity();
        return true;
    }
    APoint p{fp_to_mont(x), fp_to_mont(y), false};
    if (!on_curve(p)) return false;
    *out = p;
    return true;
}

}  // namespace

extern "C" {

// ----------------------------- pedersen -------------------------------------

// compress two fields (pedersen__compress_fields, c_bind.cpp:8-15)
void pedersen__compress_fields(const uint8_t* left, const uint8_t* right,
                               uint8_t* result) {
    Fr vals[2] = {raw_from_be<FrParams>(left), raw_from_be<FrParams>(right)};
    APoint r = encrypt_native(vals, 2, 0);
    if (r.inf) {
        std::memset(result, 0, 32);
    } else {
        fp_to_be_bytes(r.x, result);
    }
}

// compress n fields with a hash index (pedersen__compress_with_hash_index);
// inputs: n consecutive 32-byte big-endian fields
void pedersen__compress(const uint8_t* inputs, uint32_t num_inputs,
                        uint32_t hash_index, uint8_t* output) {
    std::vector<Fr> vals(num_inputs);
    for (uint32_t i = 0; i < num_inputs; ++i)
        vals[i] = raw_from_be<FrParams>(inputs + 32 * i);
    APoint r = encrypt_native(vals.data(), num_inputs, hash_index);
    if (r.inf) {
        std::memset(output, 0, 32);
    } else {
        fp_to_be_bytes(r.x, output);
    }
}

// full commitment point (the encrypt_native used by note commitments)
void pedersen__commit(const uint8_t* inputs, uint32_t num_inputs,
                      uint32_t hash_index, uint8_t* output64) {
    std::vector<Fr> vals(num_inputs);
    for (uint32_t i = 0; i < num_inputs; ++i)
        vals[i] = raw_from_be<FrParams>(inputs + 32 * i);
    APoint r = encrypt_native(vals.data(), num_inputs, hash_index);
    if (r.inf) {
        std::memset(output64, 0, 64);  // (0,0) convention, pedersen.cpp:274
    } else {
        write_point(r, output64);
    }
}

// 31-byte-chunk buffer compression (pedersen__buffer_to_field)
void pedersen__buffer_to_field(const uint8_t* data, size_t length,
                               uint8_t* r) {
    Fr out = compress_buffer_to_field(data, length, nullptr);
    raw_to_be(out, r);
}

// value * G_index via the fixed-base ladder (pedersen.hpp:44-80)
void pedersen__fixed_base_scalar_mul(const uint8_t* value32,
                                     uint32_t generator_index,
                                     uint32_t num_bits, uint8_t* out64) {
    Fr v = raw_from_be<FrParams>(value32);
    const Ladder& lad = ladder_cache().get(generator_index);
    APoint r = ladder_mul(v, (int)num_bits, lad,
                          generator_ctx().get(generator_index));
    write_point(r, out64);
}

// deterministic generator stream access (group.hpp:42-57)
void pedersen__get_generator(uint32_t index, uint8_t* out64) {
    write_point(generator_ctx().get(index), out64);
}

// ----------------------------- hashes ---------------------------------------

void blake2s__hash(const uint8_t* data, size_t length, uint8_t* out32) {
    blake2s(data, length, out32);
}

// digest interpreted as a big-endian integer mod r (blake2s c_bind.cpp
// blake2s_to_field)
void blake2s_to_field(const uint8_t* data, size_t length, uint8_t* r) {
    uint8_t h[32];
    blake2s(data, length, h);
    Fr v = raw_from_be<FrParams>(h);
    raw_to_be(v, r);
}

void keccak256__hash(const uint8_t* data, size_t length, uint8_t* out32) {
    keccak256(data, length, out32);
}

// ----------------------------- schnorr --------------------------------------

// pub = priv * grumpkin_one (schnorr c_bind.cpp compute_public_key)
void schnorr__compute_public_key(const uint8_t* private_key,
                                 uint8_t* public_key64) {
    FqOrd k = raw_from_be<FqParams>(private_key);
    APoint pub = scalar_mul(k.d, grumpkin_one());
    write_point(pub, public_key64);
}

// (s, e) = sign(msg) with explicit nonce k (randomness stays host-side in
// the caller; schnorr.tcc:6-31)
void schnorr__construct_signature(const uint8_t* message, size_t msg_len,
                                  const uint8_t* private_key,
                                  const uint8_t* nonce_k, uint8_t* sig_s,
                                  uint8_t* sig_e) {
    FqOrd priv = raw_from_be<FqParams>(private_key);
    FqOrd k = raw_from_be<FqParams>(nonce_k);
    APoint R = scalar_mul(k.d, grumpkin_one());

    std::vector<uint8_t> buf(32 + msg_len);
    fp_to_be_bytes(R.x, buf.data());
    std::memcpy(buf.data() + 32, message, msg_len);
    uint8_t e_bytes[32];
    blake2s(buf.data(), buf.size(), e_bytes);

    FqOrd e = raw_from_be<FqParams>(e_bytes);
    // s = k - priv * e (mod order), computed in Montgomery form
    FqOrd s = fp_sub(fp_to_mont(k),
                     fp_mul(fp_to_mont(priv), fp_to_mont(e)));
    raw_to_be(fp_from_mont(s), sig_s);
    std::memcpy(sig_e, e_bytes, 32);
}

// R = sG + e*pub; accept iff blake2s(R.x || m) == e (schnorr.tcc:95-121)
int schnorr__verify_signature(const uint8_t* message, size_t msg_len,
                              const uint8_t* pub64, const uint8_t* sig_s,
                              const uint8_t* sig_e) {
    APoint pub;
    if (!read_point(pub64, &pub) || pub.inf) return 0;
    FqOrd s = raw_from_be<FqParams>(sig_s);
    FqOrd e = raw_from_be<FqParams>(sig_e);
    APoint sG = scalar_mul(s.d, grumpkin_one());
    APoint ePub = scalar_mul(e.d, pub);
    JPoint Rj = j_mixed_add(j_from_affine(sG), ePub);
    APoint R = j_to_affine(Rj);
    if (R.inf) return 0;

    std::vector<uint8_t> buf(32 + msg_len);
    fp_to_be_bytes(R.x, buf.data());
    std::memcpy(buf.data() + 32, message, msg_len);
    uint8_t target[32];
    blake2s(buf.data(), buf.size(), target);
    return std::memcmp(target, sig_e, 32) == 0 ? 1 : 0;
}

}  // extern "C"
