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
ready byte, so that no request pays their build.  Ids 0 and 1 build the
rollup circuits (``rollup/rollup_circuit.py``, ``root_rollup_circuit.py``)
on one SRS factory that keeps its largest SRS; a request that fails, or
whose body does not parse, is answered with the empty failed frame and the
worker keeps serving.  Only the id-0 circuit's VK outlives its request
(0x202); the root rollup's VK, from which the rollup contract's verifier is
generated, is written to the fixture directory as ``root_rollup_vk.json``.
Each rollup request logs one ``rollup_stats`` JSON line: gates, subgroup,
the seconds of build, SRS, key, VK, proof and verification, the K1-K5
launches of the proof and the device's peak memory.  Stdout carries frames
only; every log line goes to ``log`` (stderr).
"""

from __future__ import annotations

import dataclasses
import json
import os
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


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _since(before: dict) -> dict:
    """Kernel launches since the ``field_kernels.LAUNCHES`` snapshot."""
    from ..ff import field_kernels as fk

    return {k: v - before.get(k, 0) for k, v in fk.LAUNCHES.items()
            if v - before.get(k, 0)}


def _prove_rollup(composer, unrolled: bool, who: str, build_s: float, log):
    """Key, VK, prove and verify a built rollup circuit; log its
    ``rollup_stats`` line.  Returns (proof, verified, vk)."""
    import torch

    from ..ff import field_kernels as fk

    device = composer.device
    at_start = dict(fk.LAUNCHES)
    stats = {"circuit": who, "gates": composer.n,
             "public_inputs": len(composer.public_inputs),
             "build_s": build_s}
    t = time.perf_counter()
    composer.compute_proving_key()
    _sync(device)
    stats["srs_s"] = composer.crs_factory.last_seconds
    stats["key_s"] = time.perf_counter() - t - stats["srs_s"]
    stats["subgroup"] = composer.subgroup_size()
    t = time.perf_counter()
    vk = composer.compute_verification_key()
    stats["vk_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prover = (composer.create_unrolled_prover() if unrolled
              else composer.create_prover())
    _sync(device)
    stats["witness_s"] = time.perf_counter() - t
    before = dict(fk.LAUNCHES)
    t = time.perf_counter()
    proof = prover.construct_proof()
    stats["proof_s"] = time.perf_counter() - t
    stats["proof_launches"] = _since(before)
    del prover
    t = time.perf_counter()
    verifier = (composer.create_unrolled_verifier() if unrolled
                else composer.create_verifier())
    ok = verifier.verify_proof(proof)
    stats["verify_s"] = time.perf_counter() - t
    stats["ok"] = ok
    stats["launches"] = _since(at_start)
    if device.type == "cuda":
        stats["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    print("rollup_stats " + json.dumps(stats), file=log, flush=True)
    return proof, ok, vk


def _create_tx_rollup(stdin, log, state, device):
    """proof_id 0 (ref: rollup_cli/main.cpp:31-66): prove an inner rollup
    over the received tx proofs (unrolled Turbo), padded to ``num_txs``
    with the join-split padding proof.  Its VK is kept for 0x202."""
    from ..plonk import manifests
    from ..plonk.composer import TurboComposer
    from ..rollup.circuit_data import join_split_circuit_data
    from ..rollup.rollup_circuit import rollup_circuit
    from ..rollup.serialize import read_rollup_tx

    num_txs = _read_u32(stdin)
    body = _read_exact(stdin, _read_u32(stdin))
    tx = read_rollup_tx(body)
    print(f"received tx rollup with {tx.num_txs} txs", file=log, flush=True)
    cd = join_split_circuit_data(device=device)
    while len(tx.txs) < num_txs:
        tx.txs.append(cd.padding_proof)
    t = time.perf_counter()
    composer = TurboComposer(crs_factory=state["crs"], device=device)
    rollup_circuit(composer, tx, [cd.vk], rollup_size=num_txs)
    build_s = time.perf_counter() - t
    if composer.failed:
        print(f"rollup circuit failed: {composer.err}", file=log, flush=True)
        return b"", False
    proof, ok, vk = _prove_rollup(composer, True, "tx_rollup", build_s, log)
    state["tx_rollup_vk"] = dataclasses.replace(
        vk, settings=manifests.UNROLLED_TURBO)
    return proof, ok


def _create_root_rollup(stdin, log, state, device):
    """proof_id 1 (ref: rollup_cli/main.cpp:68-113): aggregate inner rollup
    proofs (Turbo, Keccak transcript); the frame carries the inner-rollup
    VK as u32-prefixed JSON."""
    from ..plonk.composer import TurboComposer
    from ..rollup.root_rollup_circuit import root_rollup_circuit
    from ..rollup.serialize import read_root_rollup_tx
    from ..utils.fixtures import fixture_dir, vk_from_json, vk_to_json

    num_txs = _read_u32(stdin)
    num_proofs = _read_u32(stdin)
    vk_json = _read_exact(stdin, _read_u32(stdin))
    body = _read_exact(stdin, _read_u32(stdin))
    inner_vk = vk_from_json(vk_json.decode())
    tx = read_root_rollup_tx(body)
    print(f"received root rollup with {len(tx.rollups)} rollups",
          file=log, flush=True)
    t = time.perf_counter()
    composer = TurboComposer(crs_factory=state["crs"], device=device)
    root_rollup_circuit(composer, tx, inner_rollup_size=num_txs,
                        outer_rollup_size=num_txs * num_proofs,
                        inner_verification_key=inner_vk)
    build_s = time.perf_counter() - t
    if composer.failed:
        print(f"root rollup failed: {composer.err}", file=log, flush=True)
        return b"", False
    proof, ok, vk = _prove_rollup(composer, False, "root_rollup", build_s,
                                  log)
    path = os.path.join(fixture_dir(), "root_rollup_vk.json")
    with open(path + ".tmp", "w") as f:
        f.write(vk_to_json(vk))
    os.replace(path + ".tmp", path)
    return proof, ok


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

    from ..srs.reference_string import FakeReferenceStringFactory

    circuits = {"crs": FakeReferenceStringFactory(device=device)}
    while True:
        try:
            proof_id = _read_u32(stdin)
        except EOFError:
            return
        t0 = time.perf_counter()
        if proof_id in (0, 1):
            fn = _create_tx_rollup if proof_id == 0 else _create_root_rollup
            try:
                if device.type == "cuda":
                    import torch

                    torch.cuda.reset_peak_memory_stats(device)
                proof, ok = fn(stdin, log, circuits, device)
            except EOFError:
                return
            except Exception as e:  # serving boundary: report, keep serving
                print(f"proof_id {proof_id} error: {e!r}", file=log,
                      flush=True)
                traceback.print_exc(file=log)
                proof, ok = b"", False
            _write_frame(stdout, proof, ok)
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
            # VK of the tx-rollup circuit proved by the last id-0 request
            # (the root-rollup frame carries this VK); none before one
            from ..utils.fixtures import vk_to_json

            vk = circuits.get("tx_rollup_vk")
            if vk is None:
                _write_frame(stdout, b"", False)
            else:
                _write_frame(stdout, vk_to_json(vk).encode(), True)
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
