"""Prove the whole rollup tower through the port's proof worker.

Port of tools/rollup_tower.py (ref: rollup_cli/main.cpp:115-153,
rollup/proofs/rollup/verify.hpp:76, root_rollup/verify.hpp:65-110).  All
stages run through a ``python -u -m aztec_tpu_torch.serving.proof_worker``
subprocess, as the sequencer drives it:

  1. the join-split padding proof (unrolled Turbo; fixture-cached),
  2. proof_id 0: the tx-rollup frame -> the inner rollup proof (the rollup
     circuit verifies the tx proofs in-circuit),
  3. proof_id 0x202: the inner-rollup VK,
  4. proof_id 1: the root-rollup frame carrying the inner proof and VK ->
     the root rollup proof (Turbo, Keccak transcript; its verifier folds
     the recursive accumulator into the final pairing).

Writes a JSON report to the path given: sha256 and length of each proof,
seconds a stage, ok flags and the device.  Exit 0 iff both rollup proofs
verified.  On the card:

    python -m aztec_tpu_torch.tools.rollup_tower [num_txs] <out.json>
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def read_exact(stream, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            raise EOFError(f"worker died ({len(buf)}/{n} bytes)")
        buf += chunk
    return buf


def read_reply(stdout):
    size = struct.unpack(">I", read_exact(stdout, 4))[0]
    payload = read_exact(stdout, size)
    ok = read_exact(stdout, 1) == b"\x01"
    return payload, ok


def _stage(seconds: float, ok: bool, proof: bytes) -> dict:
    return {"seconds": round(seconds, 2), "ok": ok,
            "proof_sha256": hashlib.sha256(proof).hexdigest(),
            "proof_bytes": len(proof)}


def main(argv) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    num_txs = int(argv[1]) if len(argv) == 3 else 1
    out_json = argv[-1]
    import torch

    from ..rollup.circuit_data import join_split_circuit_data
    from ..rollup.create_rollup import create_rollup_tx, create_root_rollup_tx
    from ..rollup.serialize import write_rollup_tx, write_root_rollup_tx
    from ..rollup.world_state import WorldState

    report = {"num_txs": num_txs, "stages": {}}
    t_all = time.time()
    t0 = time.time()
    cd = join_split_circuit_data()
    report["stages"]["join_split_padding_proof"] = _stage(
        time.time() - t0, True, cd.padding_proof)
    print(f"join_split padding proof ready "
          f"({report['stages']['join_split_padding_proof']})", flush=True)

    # the worker's 2^24 keys need the card: the padding proof's cached
    # blocks go back first
    torch.cuda.empty_cache()
    ws = WorldState(data_depth=6, null_depth=16, root_depth=4)
    rtx = create_rollup_tx(ws, rollup_id=0,
                           tx_proofs=[cd.padding_proof] * num_txs,
                           rollup_size=num_txs)
    body = write_rollup_tx(rtx)

    worker = subprocess.Popen(
        [sys.executable, "-u", "-m", "aztec_tpu_torch.serving.proof_worker"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=sys.stderr,
        cwd=REPO)
    try:
        assert read_exact(worker.stdout, 1) == b"\x01", "worker not ready"
        t0 = time.time()
        worker.stdin.write(struct.pack(">II", 0, num_txs)
                           + struct.pack(">I", len(body)) + body)
        worker.stdin.flush()
        inner_proof, ok0 = read_reply(worker.stdout)
        report["stages"]["tx_rollup"] = _stage(time.time() - t0, ok0,
                                               inner_proof)
        print(f"tx rollup: {report['stages']['tx_rollup']}", flush=True)

        worker.stdin.write(struct.pack(">I", 0x202))
        worker.stdin.flush()
        vk_json, okv = read_reply(worker.stdout)
        if not okv:
            raise RuntimeError("no tx-rollup VK cached")

        root_tx = create_root_rollup_tx(ws, rollup_id=0,
                                        rollup_proofs=[inner_proof],
                                        new_data_root=rtx.new_data_root)
        rbody = write_root_rollup_tx(root_tx)
        t0 = time.time()
        worker.stdin.write(struct.pack(">III", 1, num_txs, 1)
                           + struct.pack(">I", len(vk_json)) + vk_json
                           + struct.pack(">I", len(rbody)) + rbody)
        worker.stdin.flush()
        root_proof, ok1 = read_reply(worker.stdout)
        report["stages"]["root_rollup"] = _stage(time.time() - t0, ok1,
                                                 root_proof)
        print(f"root rollup: {report['stages']['root_rollup']}", flush=True)
        worker.stdin.close()
        worker.wait(timeout=60)
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()

    report["total_seconds"] = round(time.time() - t_all, 2)
    report["ok"] = bool(ok0 and ok1)
    report["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": torch.cuda.device_count()}
    with open(out_json, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
