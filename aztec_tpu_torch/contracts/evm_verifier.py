"""Executable on-chain verifier: EVM bytecode generated per verification key.

The text emitter (plonk/sol_gen.py + contracts/sol/TurboVerifier.sol)
mirrors the reference's Solidity; this module makes the on-chain verifier
EXECUTABLE without solc or an EVM client: it emits raw EVM
bytecode for a given VK by SYMBOLICALLY TRACING the native verifier's own
math (plonk/verifier.py + plonk/flavors.py) — every Fr operation the
native verifier performs becomes an ADDMOD/MULMOD/MODEXP, every transcript
round a KECCAK256 over the same byte layout, every MSM term an
ecMul/ecAdd precompile call, and the final check one ecPairing call.
Because the arithmetic is traced from the same functions the native
verifier runs, the two verifiers accept/reject identically by
construction (for well-formed calldata; malformed proofs revert).

Calldata = the proof bytes exactly as serialized by the prover
(transcript.export_transcript order); public inputs ride inside the proof
(manifest round 2), unlike the reference contract's (proof, pubInputs)
ABI split.  Returns 32 bytes: 1 = valid.  Reverts on malformed points.

Supported flavors: linearised keccak settings (standard/turbo) — the
on-chain profile (ref: blockchain/contracts/verifier/TurboVerifier.sol,
cryptography/PolynomialEval.sol, Transcript.sol).

Port of aztec_tpu/contracts/evm_verifier.py.  It traces the port's own
flavors (plonk/flavors.py) and helpers (poly/arithmetic.py), which compute
the same values in the same order, so the same VK gives the same bytes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..ff.bn254 import FR_MOD, FQ_MOD
from ..evm.asm import Assembler

M = FR_MOD

# memory map
SCRATCH = 0x0000          # precompile IO (<= 0x180 for pairing)
ACC = 0x0180              # MSM accumulator point (64 B)
PT = 0x01C0               # staging point for ecMul (x, y, scalar)
SLOT_BASE = 0x0240        # traced Fr values, 32 B each
BUF = 0x10000             # transcript hash buffer


class U:
    """A reduced Fr residue living in an EVM memory slot."""

    __slots__ = ("g", "idx")

    def __init__(self, g: "EvmVerifierGen", idx: int):
        self.g = g
        self.idx = idx

    # -- helpers ---------------------------------------------------------
    def _load(self):
        self.g.load_slot(self.idx)

    def __mod__(self, m):
        assert m == M
        return self

    def __add__(self, o):
        return self.g.op_addmod(self, o)

    __radd__ = __add__

    def __mul__(self, o):
        return self.g.op_mulmod(self, o)

    __rmul__ = __mul__

    def __sub__(self, o):
        return self.g.op_submod(self, o)

    def __rsub__(self, o):
        return self.g.op_submod(o, self)

    def __neg__(self):
        return self.g.op_mulmod(self, M - 1)

    def __pow__(self, e, mod=None):
        assert mod in (None, M)
        return self.g.op_pow(self, e)


class EvmVerifierGen:
    def __init__(self, vk, flavor):
        self.vk = vk
        self.flavor = flavor
        self.s = flavor.settings
        assert self.s.hash_type == "keccak256" and \
            self.s.num_challenge_bytes == 32, "on-chain profile is keccak"
        assert self.s.use_linearisation, "on-chain profile is linearised"
        self.a = Assembler()
        self.nslots = 0
        self.offsets: Dict[str, int] = {}
        self._proof_len = 0
        self._revert = None

    # ---- slots and Fr ops ----------------------------------------------

    def new_slot(self) -> int:
        i = self.nslots
        self.nslots += 1
        return i

    def slot_addr(self, idx: int) -> int:
        return SLOT_BASE + 32 * idx

    def load_slot(self, idx: int):
        self.a.push(self.slot_addr(idx)).emit("MLOAD")

    def store_top(self) -> U:
        i = self.new_slot()
        self.a.push(self.slot_addr(i)).emit("MSTORE")
        return U(self, i)

    def _operand(self, x):
        """Put x (U or int) on the stack."""
        if isinstance(x, U):
            x._load()
        else:
            self.a.push(int(x) % M)

    def op_addmod(self, x, y) -> U:
        self.a.push(M)
        self._operand(y)
        self._operand(x)
        self.a.emit("ADDMOD")
        return self.store_top()

    def op_mulmod(self, x, y) -> U:
        self.a.push(M)
        self._operand(y)
        self._operand(x)
        self.a.emit("MULMOD")
        return self.store_top()

    def op_submod(self, x, y) -> U:
        # x + (M - y) mod M
        self.a.push(M)
        self._operand(y)
        self.a.push(M).emit("SUB")
        self._operand(x)
        self.a.emit("ADDMOD")
        return self.store_top()

    def op_pow(self, x: U, e: int) -> U:
        if e == -1:
            return self.op_modexp(x, M - 2)
        assert e >= 0
        if e == 0:
            c = self.new_slot()
            self.a.push(1).push(self.slot_addr(c)).emit("MSTORE")
            return U(self, c)
        if e > 64:  # large static exponent (zeta^n): one MODEXP call
            return self.op_modexp(x, e)
        r: Optional[U] = None
        base = x
        ebits = e
        while ebits:
            if ebits & 1:
                r = base if r is None else self.op_mulmod(r, base)
            ebits >>= 1
            if ebits:
                base = self.op_mulmod(base, base)
        return r

    def op_modexp(self, x: U, e: int) -> U:
        """MODEXP precompile: x^e mod r (32/32/32-byte header layout)."""
        a = self.a
        for off, val in ((SCRATCH, 32), (SCRATCH + 32, 32), (SCRATCH + 64, 32)):
            a.push(val).push(off).emit("MSTORE")
        x._load()
        a.push(SCRATCH + 96).emit("MSTORE")
        a.push(e).push(SCRATCH + 128).emit("MSTORE")
        a.push(M).push(SCRATCH + 160).emit("MSTORE")
        # staticcall(gas, 5, in=SCRATCH..192, out=SCRATCH, 32)
        a.push(32).push(SCRATCH).push(192).push(SCRATCH).push(5)
        a.emit("GAS").emit("STATICCALL")
        self.require_top()
        a.push(SCRATCH).emit("MLOAD")
        return self.store_top()

    def require_top(self):
        """Revert unless the top-of-stack is nonzero (consumed)."""
        ok = self.a.new_label()
        self.a.jumpi(ok)
        self.a.push(0).push(0).emit("REVERT")
        self.a.label(ok)

    # ---- proof layout -----------------------------------------------------

    def _layout(self, manifest):
        off = 0
        for r in range(manifest.get_num_rounds()):
            for el in manifest.get_round_manifest(r).elements:
                if not el.derived_by_verifier:
                    self.offsets[el.name] = off
                    off += el.num_bytes
        self._proof_len = off

    def load_fr(self, name: str) -> U:
        """Proof Fr element: calldataload + reduce mod r (the native
        verifier accepts non-canonical evals via fr_from_bytes)."""
        self.a.push(M).push(1)
        self.a.push(self.offsets[name]).emit("CALLDATALOAD")
        self.a.emit("MULMOD")
        return self.store_top()

    def check_g1(self, name: str):
        """Canonicality of a proof G1 point (y||x BE): both coords < q and
        infinity-flag clear (y >= 2^255 fails y < q) — g1_from_bytes."""
        a = self.a
        for delta in (0, 32):  # y then x
            a.push(FQ_MOD)
            a.push(self.offsets[name] + delta).emit("CALLDATALOAD")
            a.emit("LT")
            self.require_top()

    # ---- transcript ---------------------------------------------------------

    def _fs_round(self, rm, first: bool, prev_challenge_slot: Optional[int],
                  t_eval: Optional[U]):
        """Emit one apply_fiat_shamir: returns list of raw challenge slots."""
        a = self.a
        pos = BUF
        if not first:
            U(self, prev_challenge_slot)._load()
            a.push(pos).emit("MSTORE")
            pos += 32
        for el in rm.elements:
            if el.name == "circuit_size":
                a.push(self.vk.n).push(224).emit("SHL")
                a.push(pos).emit("MSTORE")
                pos += 4
            elif el.name == "public_input_size":
                a.push(self.vk.num_public_inputs).push(224).emit("SHL")
                a.push(pos).emit("MSTORE")
                pos += 4
            elif el.name == "t":
                assert t_eval is not None
                t_eval._load()
                a.push(pos).emit("MSTORE")
                pos += 32
            else:
                a.push(el.num_bytes).push(self.offsets[el.name]).push(pos)
                a.emit("CALLDATACOPY")
                pos += el.num_bytes
        a.push(pos - BUF).push(BUF).emit("KECCAK256")
        base = self.store_top()
        out = [base.idx]
        for i in range(1, rm.num_challenges):
            base._load()
            a.push(BUF).emit("MSTORE")
            a.push(i).push(BUF + 32).emit("MSTORE8")
            a.push(33).push(BUF).emit("KECCAK256")
            out.append(self.store_top().idx)
        return out

    def run_transcript(self, manifest, t_eval_fn):
        """Replay Fiat-Shamir; t_eval_fn(challenges) -> t_eval U is invoked
        between the 'z' and 'nu' rounds (it needs alpha/beta/gamma/zeta).
        Returns {challenge_name: [slots of raw 32-byte values]}."""
        ch: Dict[str, List[int]] = {}
        prev = None
        first = True
        t_eval = None
        for r in range(manifest.get_num_rounds()):
            rm = manifest.get_round_manifest(r)
            if rm.num_challenges == 0:
                continue
            if rm.challenge == "nu":
                t_eval = t_eval_fn(ch)
            slots = self._fs_round(rm, first, prev, t_eval)
            ch[rm.challenge] = slots
            prev = slots[-1]
            first = False
        return ch

    def fr_of(self, slot: int) -> U:
        """Raw 32-byte challenge -> Fr residue."""
        self.a.push(M).push(1)
        U(self, slot)._load()
        self.a.emit("MULMOD")
        return self.store_top()

    # ---- MSM ------------------------------------------------------------------

    def msm_init(self):
        """ACC <- point at infinity (0, 0) (precompile identity encoding)."""
        self.a.push(0).push(ACC).emit("MSTORE")
        self.a.push(0).push(ACC + 32).emit("MSTORE")

    def msm_add_term(self, point, scalar: U):
        """ACC += scalar * point.  point: ("proof", name) calldata point or
        (x, y) ints (VK constant / generator)."""
        a = self.a
        if isinstance(point, tuple) and point[0] == "proof":
            name = point[1]
            # proof points are y||x big-endian
            a.push(self.offsets[name] + 32).emit("CALLDATALOAD")
            a.push(PT).emit("MSTORE")
            a.push(self.offsets[name]).emit("CALLDATALOAD")
            a.push(PT + 32).emit("MSTORE")
        else:
            x, y = point
            a.push(x).push(PT).emit("MSTORE")
            a.push(y).push(PT + 32).emit("MSTORE")
        scalar._load()
        a.push(PT + 64).emit("MSTORE")
        # ecMul -> PT
        a.push(64).push(PT).push(96).push(PT).push(7)
        a.emit("GAS").emit("STATICCALL")
        self.require_top()
        # ecAdd(ACC, PT) -> ACC  (contiguous: ACC at 0x180, PT at 0x1C0)
        a.push(64).push(ACC).push(128).push(ACC).push(6)
        a.emit("GAS").emit("STATICCALL")
        self.require_top()

    # ---- top level --------------------------------------------------------------

    def generate(self) -> bytes:
        vk = self.vk
        s = self.s
        flavor = self.flavor
        width = flavor.width
        a = self.a
        manifest = s.create_manifest(vk.num_public_inputs)
        self._layout(manifest)

        # proof length check
        a.emit("CALLDATASIZE").push(self._proof_len).emit("EQ")
        self.require_top()

        # canonicality of all proof G1 points (g1_from_bytes)
        g1_names = [item.commitment_label
                    for item in s.polynomial_manifest
                    if item.source == "witness"]
        g1_names += [f"T_{i+1}" for i in range(width)]
        g1_names += ["PI_Z", "PI_Z_OMEGA"]
        for name in g1_names:
            self.check_g1(name)

        ev: Dict[str, U] = {}
        holder = {}

        def t_eval_fn(chs):
            ch = {
                "alpha": self.fr_of(chs["alpha"][0]),
                "beta": self.fr_of(chs["beta"][0]),
                "gamma": self.fr_of(chs["beta"][1]),
                "zeta": self.fr_of(chs["z"][0]),
            }
            holder["ch"] = ch
            zeta = ch["zeta"]
            # lagrange evaluations + public-input delta: symbolic trace of
            # the native helpers (poly/arithmetic.py)
            from ..poly.arithmetic import (
                compute_public_input_delta,
                get_lagrange_evaluations,
            )

            vanishing, l_start, l_end = get_lagrange_evaluations(
                zeta, vk.n, vk.domain_root,
                s.num_roots_cut_out_of_vanishing_polynomial)
            holder["lag"] = (vanishing, l_start, l_end)

            for info in s.polynomial_manifest:
                if not info.is_linearised or not s.use_linearisation:
                    ev[info.polynomial_label] = self.load_fr(
                        info.polynomial_label)
                if info.requires_shifted_evaluation:
                    lab = info.polynomial_label + "_omega"
                    ev[lab] = self.load_fr(lab)
            if s.use_linearisation:
                ev["r"] = self.load_fr("r")

            pubs = []
            pub_off = self.offsets["public_inputs"]
            for i in range(vk.num_public_inputs):
                a.push(M).push(1)
                a.push(pub_off + 32 * i).emit("CALLDATALOAD")
                a.emit("MULMOD")
                pubs.append(self.store_top())
            delta = compute_public_input_delta(
                pubs, ch["beta"], ch["gamma"], vk.domain_root)

            t_eval = flavor.verifier_t_contribution(
                ev, ch, l_start, l_end, delta)
            t_eval = t_eval * pow(vanishing, -1, M) % M
            holder["t_eval"] = t_eval
            return t_eval

        chs = self.run_transcript(manifest, t_eval_fn)
        ch = holder["ch"]
        t_eval = holder["t_eval"]
        zeta = ch["zeta"]
        separator = self.fr_of(chs["separator"][0])

        cmap = manifest.challenge_map()

        def nu(label):
            key = cmap[label]
            if key == -1:
                return 1
            return self.fr_of(chs["nu"][key])

        # Kate batch-verification scalars — same traversal as
        # plonk/verifier.py _accumulate (kate_commitment_scheme.cpp:238-371)
        g1_elements: Dict[str, object] = {}
        fr_scalars: Dict[str, object] = {}
        batch_eval = 0
        for item in s.polynomial_manifest:
            label = item.commitment_label
            plabel = item.polynomial_label
            if item.source == "witness":
                g1_elements[label] = ("proof", label)
            else:
                g1_elements[label] = vk.commitments[label]
            scalar = 0
            if item.requires_shifted_evaluation:
                c = nu(plabel + "_omega")
                scalar = (scalar + separator * c) % M
                batch_eval = (batch_eval
                              + separator * c % M * ev[plabel + "_omega"]) % M
            if not item.is_linearised or not s.use_linearisation:
                c = nu(plabel)
                scalar = (scalar + c) % M
                batch_eval = (batch_eval + c * ev[plabel]) % M
            fr_scalars[label] = scalar

        z_pow_n = pow(zeta, vk.n, M)
        tq = nu("t")
        z_power = 1
        for i in range(width):
            label = f"T_{i+1}"
            g1_elements[label] = ("proof", label)
            fr_scalars[label] = tq * z_power % M
            z_power = z_power * z_pow_n % M

        if s.use_linearisation:
            batch_eval = (batch_eval + nu("r") * ev["r"]) % M
        batch_eval = (batch_eval + t_eval * tq) % M
        g1_elements["BATCH_EVALUATION"] = (1, 2)
        fr_scalars["BATCH_EVALUATION"] = (-batch_eval) % M

        if s.use_linearisation:
            linear_nu = nu("r")
            lag = holder["lag"]
            z_mult, sigma_mult = flavor.perm_linear_terms(ev, ch, lag[1])
            fr_scalars["Z"] = (fr_scalars.get("Z", 0)
                               + z_mult * linear_nu) % M
            fr_scalars[f"SIGMA_{width}"] = (
                fr_scalars.get(f"SIGMA_{width}", 0)
                + sigma_mult * linear_nu) % M
            label_map = {
                "q_m": "Q_M", "q_1": "Q_1", "q_2": "Q_2", "q_3": "Q_3",
                "q_4": "Q_4", "q_5": "Q_5", "q_c": "Q_C",
                "q_arith": "Q_ARITHMETIC_SELECTOR",
                "q_range": "Q_RANGE_SELECTOR",
                "q_ecc_1": "Q_FIXED_BASE_SELECTOR",
                "q_logic": "Q_LOGIC_SELECTOR",
                "q_mimc_selector": "Q_MIMC_SELECTOR",
            }
            for plabel, scalar in flavor.selector_linear_scalars(
                    ev, ch).items():
                label = label_map[plabel]
                fr_scalars[label] = (fr_scalars.get(label, 0)
                                     + scalar * linear_nu) % M

        g1_elements["PI_Z"] = ("proof", "PI_Z")
        fr_scalars["PI_Z"] = zeta
        g1_elements["PI_Z_OMEGA"] = ("proof", "PI_Z_OMEGA")
        fr_scalars["PI_Z_OMEGA"] = zeta * vk.domain_root % M * separator % M

        # ---- MSM: P0 = sum scalar_i * point_i ------------------------------
        self.msm_init()
        for label, pt in g1_elements.items():
            if pt is None:
                continue
            sc = fr_scalars[label]
            if not isinstance(sc, U):
                sc_u = self.op_mulmod(1, sc)  # materialize constant
            else:
                sc_u = sc
            self.msm_add_term(pt, sc_u)

        # P1 = -(separator * PI_Z_OMEGA + PI_Z): compute S = sep*PI_Z_OMEGA
        # + PI_Z into ACC2 region, then negate y.
        # reuse staging: sep * PI_Z_OMEGA -> PT
        a.push(self.offsets["PI_Z_OMEGA"] + 32).emit("CALLDATALOAD")
        a.push(PT).emit("MSTORE")
        a.push(self.offsets["PI_Z_OMEGA"]).emit("CALLDATALOAD")
        a.push(PT + 32).emit("MSTORE")
        separator._load()
        a.push(PT + 64).emit("MSTORE")
        a.push(64).push(PT).push(96).push(PT).push(7)
        a.emit("GAS").emit("STATICCALL")
        self.require_top()
        # + PI_Z: ecAdd(PT, PI_Z) -> PT (need contiguous input: copy PI_Z
        # after PT)
        a.push(self.offsets["PI_Z"] + 32).emit("CALLDATALOAD")
        a.push(PT + 64).emit("MSTORE")
        a.push(self.offsets["PI_Z"]).emit("CALLDATALOAD")
        a.push(PT + 96).emit("MSTORE")
        a.push(64).push(PT).push(128).push(PT).push(6)
        a.emit("GAS").emit("STATICCALL")
        self.require_top()
        # negate y: y' = q - y (y == 0 stays 0 for the identity)
        a.push(PT + 32).emit("MLOAD")
        done = a.new_label()
        a.emit("DUP1").emit("ISZERO").jumpi(done)
        a.push(FQ_MOD).emit("SUB")
        # fallthrough leaves q - y; at `done` the zero y stays
        a.label(done)
        a.push(PT + 32).emit("MSTORE")

        # ---- pairing: e(P0, [1]_2) * e(P1, [x]_2) == 1 ----------------------
        # input layout: P0(64) g2gen(128) P1(64) g2x(128) at SCRATCH
        from ..curves.tower import G2_GEN

        a.push(ACC).emit("MLOAD").push(SCRATCH).emit("MSTORE")
        a.push(ACC + 32).emit("MLOAD").push(SCRATCH + 32).emit("MSTORE")
        for base_off, g2 in ((SCRATCH + 64, G2_GEN),
                             (SCRATCH + 256, vk.g2_x)):
            (xr, xi), (yr, yi) = g2
            a.push(xi).push(base_off).emit("MSTORE")
            a.push(xr).push(base_off + 32).emit("MSTORE")
            a.push(yi).push(base_off + 64).emit("MSTORE")
            a.push(yr).push(base_off + 96).emit("MSTORE")
        a.push(PT).emit("MLOAD").push(SCRATCH + 192).emit("MSTORE")
        a.push(PT + 32).emit("MLOAD").push(SCRATCH + 224).emit("MSTORE")
        a.push(32).push(SCRATCH).push(384).push(SCRATCH).push(8)
        a.emit("GAS").emit("STATICCALL")
        self.require_top()
        a.push(SCRATCH).emit("MLOAD")
        a.push(0).emit("MSTORE")
        a.push(32).push(0).emit("RETURN")

        return a.assemble()


def generate_verifier(vk, flavor=None) -> bytes:
    """EVM bytecode verifying proofs for `vk` (keccak linearised flavors)."""
    if flavor is None:
        from ..plonk.flavors import FLAVORS

        flavor = FLAVORS[vk.settings.name]
    return EvmVerifierGen(vk, flavor).generate()
