"""Host circuit-satisfiability checker.

Evaluates every gate identity row-by-row with exact integer arithmetic,
grouped by independent alpha power as the quotient kernels combine them
(kernels._std_terms, _turbo_terms, _mimc_terms): each group must vanish on
every gate row for the circuit to be satisfiable.  Port of
aztec_tpu/plonk/circuit_check.py: ``check_standard``, ``check_turbo`` and
``check_mimc``.
"""

from __future__ import annotations

from ..ff.bn254 import FR_MOD

M = FR_MOD


def _rows(composer):
    """(wires, selectors) per final-layout row for the gate region."""
    num_pub = len(composer.public_inputs)
    wl = composer._wire_lists()
    width = len(wl)
    n = composer.n

    def wire(col, row):
        # gate rows live at [num_pub + row]; shifted access may run into
        # the zero padding
        if row < n:
            return composer.get_variable(wl[col][row])
        return 0

    return num_pub, width, n, wire


def check_standard(composer) -> list:
    """Returns [(row, description)] of violated standard arithmetic gates."""
    _, _, n, wire = _rows(composer)
    bad = []
    for i in range(n):
        a, b, c = wire(0, i), wire(1, i), wire(2, i)
        v = (
            composer.q_m[i] * a * b + composer.q_1[i] * a
            + composer.q_2[i] * b + composer.q_3[i] * c + composer.q_c[i]
        ) % M
        if v != 0:
            bad.append((i, "arithmetic"))
    return bad


def check_turbo(composer) -> list:
    """Returns [(row, alpha-group)] of violated turbo gate identities."""
    _, _, n, wire = _rows(composer)
    bad = []
    for i in range(n):
        a, b, c, d = (wire(k, i) for k in range(4))
        aw, bw, cw, dw = (wire(k, i + 1) for k in range(4))
        qm = composer.q_m[i]
        q1, q2, q3 = composer.q_1[i], composer.q_2[i], composer.q_3[i]
        q4, q5, qc = composer.q_4[i], composer.q_5[i], composer.q_c[i]
        qarith = composer.q_arith[i]
        qecc = composer.q_ecc_1[i]
        qrange = composer.q_range[i]
        qlogic = composer.q_logic[i]

        def chk(name, v):
            if v % M != 0:
                bad.append((i, name))

        # arithmetic (alpha^4, alpha^5)
        chk("arith", qarith * (qm * a * b + q1 * a + q2 * b + q3 * c
                               + q4 * d + qc))
        chk("arith_q5", qarith * q5 * (d * d - d) % M * ((d - 2) % M))
        dlt = (c - 4 * d) % M
        chk("arith_quad",
            (qarith * qarith - qarith) * dlt % M
            * ((9 * dlt - 2 * dlt * dlt - 7) % M))

        if qecc:
            de = (dw - 4 * d) % M
            chk("fb_acc", qecc * (de + 1) * (de + 3) % M * ((de - 1) % M)
                % M * ((de - 3) % M))
            chk("fb_xalpha", qecc * (q1 * de * de + q2 - cw))
            x_acc = (
                (aw + a + cw) * pow((cw - a) % M, 2, M)
                - (cw * cw % M * cw + b * b - 17)
                + 2 * de * b % M * qecc
            ) % M
            chk("fb_xacc", qecc * (x_acc + q3 * 2 * de % M * cw % M * b))
            y_acc = ((bw + b) * ((cw - a) % M) + (a - aw) * ((b - qecc * de) % M)) % M
            chk("fb_yacc", qecc * (y_acc + q3 * ((aw - a) % M) % M * de % M * cw))
            chk("fb_accinit", qecc * qc * ((d - 1) % M) % M * ((d - 1 - c) % M))
            chk("fb_init1", qecc * qc % M * (q4 * c + q5 * ((1 - d) % M) - a * c))
            chk("fb_init2", qecc * qc % M * (qm * c + ((1 - d) * qc - b * c) % M))

        if qrange:
            for name, x in (("r1", (c - 4 * d) % M), ("r2", (b - 4 * c) % M),
                            ("r3", (a - 4 * b) % M), ("r4", (dw - 4 * a) % M)):
                chk(f"range_{name}",
                    qrange * x * ((x - 1) % M) % M * ((x - 2) % M) % M
                    * ((x - 3) % M))

        if qlogic:
            qa = (aw - 4 * a) % M
            qb = (bw - 4 * b) % M
            qcq = (dw - 4 * d) % M
            chk("logic_ab", qlogic * ((qa + qb) * (qa + qb) - qa * qa
                                      - qb * qb - 2 * c))
            chk("logic_ra", qlogic * (qa * qa - qa) % M
                * ((qa * qa - 5 * qa + 6) % M))
            chk("logic_rb", qlogic * (qb * qb - qb) % M
                * ((qb * qb - 5 * qb + 6) % M))
            ds = (qa + qb) % M
            dss = (qa * qa + qb * qb) % M
            w_term = ((4 * c - 18 * ds + 81) % M) * c % M
            w_term = (w_term + 18 * dss - 81 * ds + 83) % M * c % M
            t3 = (9 * qcq - 3 * ds) % M * qc % M
            t2 = (3 * qcq + 3 * ds - 2 * w_term + t3) % M
            chk("logic_c", qlogic * t2)
    return bad


def check_mimc(composer) -> list:
    """Returns [(row, description)] of violated mimc-composer identities
    (standard arithmetic + the x^7 gate, mimc_widget.hpp)."""
    composer._flush_mimc()
    bad = check_standard(composer)
    _, _, n, wire = _rows(composer)
    for i in range(n):
        if composer.q_mimc_selector[i] == 0:
            continue
        k, x_cubed, x_in = wire(0, i), wire(1, i), wire(2, i)
        x_out = wire(2, i + 1)
        t0 = (x_in + k + composer.q_mimc_coefficient[i]) % M
        if (t0 * t0 % M * t0 - x_cubed) % M != 0:
            bad.append((i, "mimc_cube"))
        if (x_cubed * x_cubed % M * t0 - x_out) % M != 0:
            bad.append((i, "mimc_seven"))
    return sorted(bad)
