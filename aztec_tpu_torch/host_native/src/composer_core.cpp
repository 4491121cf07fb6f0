// Native composer core: the host-side circuit-construction hot path.
//
// Division of labour: the reference's ComposerBase
// (plonk/composer/composer_base.cpp) interleaves gate recording with C++
// field math; here the native core owns the O(gates) host work — variable
// store, equivalence-class chains, gate/selector recording, copy-cycle ->
// sigma mapping construction, witness assembly — and exports flat numpy-
// compatible buffers that the Python layer ships to the device kernels
// (sigma synthesis, iFFT/FFT, MSM).  All values are BN254 Fr in canonical
// form, 4x64-bit little-endian limbs.
//
// C API (ctypes-friendly); all functions are thread-compatible but not
// thread-safe per ComposerCore instance.

#include <cstdint>
#include <cstring>
#include <vector>

#include "fr.hpp"

using aztec_tpu::fr;

namespace {

constexpr uint32_t REAL_VARIABLE = 0xFFFFFFFFu;
constexpr uint32_t FIRST_IN_CLASS = 0xFFFFFFFEu;

struct ComposerCore {
    std::vector<fr> variables;
    std::vector<uint32_t> next_var;
    std::vector<uint32_t> prev_var;
    std::vector<uint32_t> real_idx;
    std::vector<uint32_t> public_inputs;

    // width-4 wire columns (standard uses first 3)
    std::vector<uint32_t> w[4];
    // selector columns, registered dynamically
    std::vector<std::vector<fr>> selectors;
    uint32_t num_selectors = 0;
    uint64_t n = 0;  // gate count
    bool failed = false;

    uint32_t first_in_class(uint32_t idx) const {
        idx = real_idx[idx];
        while (prev_var[idx] != FIRST_IN_CLASS) idx = prev_var[idx];
        return idx;
    }
};

}  // namespace

extern "C" {

ComposerCore* cc_new(uint32_t num_selectors) {
    auto* c = new ComposerCore();
    c->num_selectors = num_selectors;
    c->selectors.resize(num_selectors);
    return c;
}

void cc_free(ComposerCore* c) { delete c; }

uint32_t cc_add_variable(ComposerCore* c, const uint64_t value[4]) {
    fr v;
    std::memcpy(v.d, value, 32);
    uint32_t idx = (uint32_t)c->variables.size();
    c->variables.push_back(v);
    c->next_var.push_back(REAL_VARIABLE);
    c->prev_var.push_back(FIRST_IN_CLASS);
    c->real_idx.push_back(idx);
    return idx;
}

void cc_get_variable(ComposerCore* c, uint32_t idx, uint64_t out[4]) {
    std::memcpy(out, c->variables[c->real_idx[idx]].d, 32);
}

void cc_set_public(ComposerCore* c, uint32_t idx) {
    c->public_inputs.push_back(idx);
}

// returns 0 on success, 1 if values differ (composer enters failed state)
int cc_assert_equal(ComposerCore* c, uint32_t a_idx, uint32_t b_idx) {
    int rc = 0;
    if (!(c->variables[c->real_idx[a_idx]] == c->variables[c->real_idx[b_idx]])) {
        c->failed = true;
        rc = 1;
    }
    uint32_t a_real = c->real_idx[a_idx];
    uint32_t b_real = c->real_idx[b_idx];
    if (a_real == b_real) return rc;
    uint32_t b_start = c->first_in_class(b_idx);
    for (uint32_t cur = b_start;;) {
        c->real_idx[cur] = a_real;
        uint32_t nxt = c->next_var[cur];
        if (nxt == REAL_VARIABLE) break;
        cur = nxt;
    }
    uint32_t a_start = c->first_in_class(a_idx);
    c->next_var[b_real] = a_start;
    c->prev_var[a_start] = b_real;
    return rc;
}

int cc_failed(ComposerCore* c) { return c->failed ? 1 : 0; }

// record one gate: wire indices (width entries) + selector values
// (num_selectors x 4 canonical limbs, row-major)
void cc_gate(ComposerCore* c, uint32_t width, const uint32_t* wires,
             const uint64_t* selector_vals) {
    for (uint32_t k = 0; k < width; ++k) c->w[k].push_back(wires[k]);
    for (uint32_t s = 0; s < c->num_selectors; ++s) {
        fr v;
        std::memcpy(v.d, selector_vals + 4 * s, 32);
        c->selectors[s].push_back(v);
    }
    c->n++;
}

uint64_t cc_num_gates(ComposerCore* c) { return c->n; }
uint64_t cc_num_public(ComposerCore* c) { return (uint64_t)c->public_inputs.size(); }
uint64_t cc_num_vars(ComposerCore* c) { return (uint64_t)c->variables.size(); }

// selector polynomial layout (ref: composer_base.cpp:160-214):
// [0]*num_pub + gates + [0]*(subgroup-1-n-num_pub) + [1]
void cc_export_selector(ComposerCore* c, uint32_t sel, uint64_t subgroup,
                        uint64_t* out /* subgroup*4 limbs */) {
    uint64_t num_pub = c->public_inputs.size();
    std::memset(out, 0, subgroup * 32);
    const auto& s = c->selectors[sel];
    for (uint64_t i = 0; i < c->n; ++i) {
        std::memcpy(out + 4 * (num_pub + i), s[i].d, 32);
    }
    out[4 * (subgroup - 1)] = 1;
}

// witness wire column (ref: composer_base.cpp:216-264): first num_pub rows
// carry the public value in columns 0 and 1 (0 elsewhere), gates follow,
// zero-padded to the subgroup size.
void cc_export_witness(ComposerCore* c, uint32_t col, uint64_t subgroup,
                       uint64_t* out) {
    uint64_t num_pub = c->public_inputs.size();
    std::memset(out, 0, subgroup * 32);
    if (col < 2) {
        for (uint64_t i = 0; i < num_pub; ++i) {
            std::memcpy(out + 4 * i,
                        c->variables[c->real_idx[c->public_inputs[i]]].d, 32);
        }
    }
    for (uint64_t i = 0; i < c->n; ++i) {
        std::memcpy(out + 4 * (num_pub + i),
                    c->variables[c->real_idx[c->w[col][i]]].d, 32);
    }
}

// copy cycles -> sigma mappings (ref: composer_base.cpp:38-158).
// next_row: width x subgroup int32; factor: width x subgroup uint8 with
// 0..width-1 = column coset index, 255 = public-input (external) marker
// mapped by the caller.
void cc_sigma_mappings(ComposerCore* c, uint32_t width, uint64_t subgroup,
                       int32_t* next_row, uint8_t* factor) {
    uint64_t num_pub = c->public_inputs.size();
    uint64_t nvars = c->variables.size();

    // identity init
    for (uint32_t col = 0; col < width; ++col) {
        for (uint64_t i = 0; i < subgroup; ++i) {
            next_row[col * subgroup + i] = (int32_t)i;
            factor[col * subgroup + i] = (uint8_t)col;
        }
    }

    // build cycles: per real variable, ordered list of (row, col)
    std::vector<std::vector<uint64_t>> cycles(nvars);  // packed row<<3|col
    for (uint64_t i = 0; i < num_pub; ++i) {
        uint32_t real = c->real_idx[c->public_inputs[i]];
        cycles[real].push_back((i << 3) | 0);
        cycles[real].push_back((i << 3) | 1);
    }
    for (uint64_t i = 0; i < c->n; ++i) {
        for (uint32_t col = 0; col < width; ++col) {
            uint32_t real = c->real_idx[c->w[col][i]];
            cycles[real].push_back(((i + num_pub) << 3) | col);
        }
    }

    for (const auto& cyc : cycles) {
        size_t m = cyc.size();
        for (size_t j = 0; j < m; ++j) {
            uint64_t cur = cyc[j];
            uint64_t nxt = cyc[(j + 1) % m];
            uint64_t row = cur >> 3;
            uint32_t col = (uint32_t)(cur & 7);
            next_row[col * subgroup + row] = (int32_t)(nxt >> 3);
            factor[col * subgroup + row] = (uint8_t)(nxt & 7);
        }
    }

    // public-input consistency override on column 0
    for (uint64_t i = 0; i < num_pub; ++i) {
        next_row[i] = (int32_t)i;
        factor[i] = 255;
    }
}

}  // extern "C"
