"""Long-lived proof worker over stdin/stdout (ref: rollup_cli/main.cpp).

Protocol (all integers big-endian, matching the reference's serialize.hpp):

  worker -> client on start:  bool ready (1 byte, 0x01)
  client -> worker, repeated: u32 proof_id, then a request body
  worker -> client:           vector<u8> proof (u32 length prefix) + u8 ok

proof_id (ref: rollup_cli/main.cpp:131-149):
  0      tx-rollup proof: body = u32 num_txs, then a u32-prefixed
         serialized rollup_tx
  1      root-rollup proof: body = u32 num_txs, u32 num_proofs, the
         u32-prefixed inner-rollup VK JSON, then a u32-prefixed serialized
         root_rollup_tx
  0x100  standard-PLONK demo proof: body = u32 num_gates (builds the
         benchmark circuit of that size, proves, returns proof bytes)
  0x101  turbo-PLONK demo proof: same body
  0x200  join_split verification key (no body; u32-prefixed JSON reply —
         halloumi getJoinSplitVk, server.ts:34-36)
  0x201  account verification key (halloumi getAccountVk, server.ts:38-40)
  0x202  VK of the tx-rollup circuit proved by the last proof_id-0 request
         (u32-prefixed JSON; the root-rollup frame carries this VK)

Port of aztec_tpu/serving/proof_worker.py.  It proves on ``device``, the
card unless ``"cpu"`` is given, and loads the kernel libraries before the
ready byte, so that no request pays their build.  The rollup circuits that
ids 0 and 1 prove are not ported yet: their frames are read to the end as
the reference reads them, logged, and answered with the empty failed frame
the reference sends when a request raises, and the worker keeps serving.
So 0x202 answers the failed frame too, as the reference does before any
id-0 proof.  Stdout carries frames only; every
log line goes to ``log`` (stderr).
"""

from __future__ import annotations

import struct
import sys
import time
import traceback


def _read_exact(stream, n: int) -> bytes:
    data = stream.read(n)
    if data is None or len(data) < n:
        raise EOFError
    return data


def _read_u32(stream) -> int:
    return struct.unpack(">I", _read_exact(stream, 4))[0]


def _build_demo_circuit(kind: str, num_gates: int, device):
    from ..plonk.composer import StandardComposer, TurboComposer, AddTriple, MulTriple
    from ..ff.bn254 import FR_MOD

    cls = StandardComposer if kind == "standard" else TurboComposer
    c = cls(device=device)
    a = c.add_variable(3)
    b = c.add_variable(4)
    prod = c.add_variable(12)
    c.create_mul_gate(MulTriple(a, b, prod, 1, -1, 0))
    acc_val, acc = 12, prod
    while c.n < num_gates:
        acc_val = (acc_val + 3) % FR_MOD
        nxt = c.add_variable(acc_val)
        c.create_add_gate(AddTriple(acc, a, nxt, 1, 1, -1, 0))
        acc = nxt
    return c


def _skip_rollup_request(proof_id: int, body_stream) -> None:
    """Read the body of an id-0 or id-1 frame as the reference's
    ``_create_tx_rollup`` and ``_create_root_rollup`` do, so that the
    stream stays framed."""
    _read_u32(body_stream)                      # num_txs
    if proof_id == 1:
        _read_u32(body_stream)                  # num_proofs
        _read_exact(body_stream, _read_u32(body_stream))    # inner VK JSON
    _read_exact(body_stream, _read_u32(body_stream))        # the tx


def _load_kernels(device) -> None:
    """Build (where missing) and load the prover's kernel libraries; the
    build's compiler output is piped, never written to stdout."""
    if device.type != "cuda":
        return
    from .. import native

    for name in ("field_ops", "group_ops", "rake", "bucket"):
        native.library(name)


def _write_frame(stdout, payload: bytes, ok: bool) -> None:
    stdout.write(struct.pack(">I", len(payload)) + payload)
    stdout.write(b"\x01" if ok else b"\x00")
    stdout.flush()


def serve(stdin=None, stdout=None, log=sys.stderr, device="cuda"):
    from ..plonk.composer import _device

    device = _device(device, "proof worker")
    _load_kernels(device)

    stdin = stdin or sys.stdin.buffer
    stdout = stdout or sys.stdout.buffer

    stdout.write(b"\x01")
    stdout.flush()

    circuits = {}
    while True:
        try:
            proof_id = _read_u32(stdin)
        except EOFError:
            return
        t0 = time.perf_counter()
        if proof_id in (0, 1):
            try:
                _skip_rollup_request(proof_id, stdin)
            except EOFError:
                return
            # the reference's answer to a request that raised; keep serving
            print(f"proof_id {proof_id} needs the rollup circuits, not "
                  "ported yet", file=log, flush=True)
            _write_frame(stdout, b"", False)
        elif proof_id in (0x100, 0x101):
            num_gates = _read_u32(stdin)
            kind = "standard" if proof_id == 0x100 else "turbo"
            key = (kind, num_gates)
            if key not in circuits:
                circuits[key] = _build_demo_circuit(kind, num_gates, device)
            c = circuits[key]
            print(f"proving {kind} circuit, {c.n} gates...", file=log, flush=True)
            proof = c.create_prover().construct_proof()
            ok = c.create_verifier().verify_proof(proof)
            _write_frame(stdout, proof, ok)
        elif proof_id == 0x202:
            # the VK of the last id-0 proof: none until ids 0 and 1 are
            # ported, so the failed frame the reference sends before one
            _write_frame(stdout, b"", False)
        elif proof_id in (0x200, 0x201):
            # verification-key queries (halloumi getJoinSplitVk /
            # getAccountVk, server.ts:34-40) — body-less request, returns
            # the circuit VK as u32-prefixed JSON
            from ..rollup.circuit_data import (
                account_circuit_data,
                join_split_circuit_data,
            )
            from ..utils.fixtures import vk_to_json

            try:
                cd = (join_split_circuit_data(device=device)
                      if proof_id == 0x200
                      else account_circuit_data(device=device))
                payload, ok = vk_to_json(cd.vk).encode(), True
            except Exception as e:  # serving boundary: report, keep serving
                print(f"vk query error: {e!r}", file=log, flush=True)
                traceback.print_exc(file=log)
                payload, ok = b"", False
            _write_frame(stdout, payload, ok)
        else:
            # unknown id: we can't know the payload length, so the stream
            # is unrecoverable — send an empty failed frame then exit; the
            # HTTP layer's reset() restarts us (halloumi server.ts:46-49)
            print(f"unknown proof_id {proof_id}", file=log, flush=True)
            _write_frame(stdout, b"", False)
            return
        print(f"proof_id {proof_id:#x}: {time.perf_counter() - t0:.3f} s",
              file=log, flush=True)


if __name__ == "__main__":
    serve()
