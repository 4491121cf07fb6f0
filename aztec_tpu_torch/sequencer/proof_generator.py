"""Proof-generation clients (ref: halloumi/proof_generator consumed from
falafel/src/rollup_creator.ts:1-40).

The sequencer never proves anything itself: it frames proof_id-0/1 requests
(serving/proof_worker.py protocol) and sends them to a proof service —
either the HTTP server (falafel -> halloumi) or an in-process worker child.
Tests inject a mock (the reference's jest-mocked ProofGenerator,
pipeline_coordinator.test.ts).

Port of aztec_tpu/sequencer/proof_generator.py: ``WorkerProofGenerator``
drives the port's ``serving.http_server.WorkerClient`` (the worker proves
on the card), ``HttpProofGenerator`` the port's HTTP server.
"""

from __future__ import annotations

import struct
import urllib.request
from typing import Protocol

from ..rollup.rollup_circuit import RollupTx
from ..rollup.root_rollup_circuit import RootRollupTx
from ..rollup.serialize import write_rollup_tx, write_root_rollup_tx


def tx_rollup_frame(tx: RollupTx, num_txs: int) -> bytes:
    """proof_id 0 request frame (worker protocol)."""
    body = write_rollup_tx(tx)
    return (struct.pack(">II", 0, num_txs)
            + struct.pack(">I", len(body)) + body)


def root_rollup_frame(tx: RootRollupTx, num_txs: int, num_proofs: int,
                      inner_vk_json: str) -> bytes:
    """proof_id 1 request frame (worker protocol)."""
    body = write_root_rollup_tx(tx)
    vk = inner_vk_json.encode()
    return (struct.pack(">III", 1, num_txs, num_proofs)
            + struct.pack(">I", len(vk)) + vk
            + struct.pack(">I", len(body)) + body)


class ProofGenerator(Protocol):
    def create_proof(self, frame: bytes) -> bytes: ...
    def reset(self) -> None: ...


class HttpProofGenerator:
    """Talks to serving/http_server.py (falafel -> halloumi over HTTP)."""

    def __init__(self, base_url: str = "http://127.0.0.1:8082"):
        self.base_url = base_url.rstrip("/")

    def create_proof(self, frame: bytes) -> bytes:
        req = urllib.request.Request(
            self.base_url + "/create-proof", data=frame, method="POST")
        with urllib.request.urlopen(req) as resp:
            if resp.status != 200:
                raise RuntimeError(f"proof service: {resp.status}")
            return resp.read()

    def reset(self):
        req = urllib.request.Request(
            self.base_url + "/reset", data=b"", method="POST")
        urllib.request.urlopen(req).read()


class WorkerProofGenerator:
    """Owns an in-process worker child (the halloumi CliProofGenerator
    seam without HTTP; serving/http_server.WorkerClient does the piping)."""

    def __init__(self):
        from ..serving.http_server import WorkerClient

        self.client = WorkerClient()
        self.client.start()

    def create_proof(self, frame: bytes) -> bytes:
        return self.client.create_proof(frame)

    def reset(self):
        self.client.reset()
