"""Sequencer HTTP API (ref: falafel/src/app.ts Koa routes + GraphQL
status resolvers; REST subset).

  GET  /status        -> pipeline + world-state status JSON
  POST /tx            -> submit a tx proof (body = raw proof bytes);
                         202 {"txId": hex} or 400 with the rejection reason
  POST /flush         -> force a rollup on the next coordinator tick
  GET  /rollups       -> recent rollups JSON
  GET  /metrics       -> Prometheus text exposition (falafel metrics/index.ts)

Run: python -m aztec_tpu_torch.sequencer.server [port] (requires a proof
service on AZTEC_PROOF_URL, default http://127.0.0.1:8082: the port's
``python -m aztec_tpu_torch.serving.http_server 8082``).

Port of aztec_tpu/sequencer/server.py.
"""

from __future__ import annotations

import json
import os
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .proof_generator import HttpProofGenerator
from .rollup_pipeline import RollupPipeline, SequencerConfig
from .tx_receiver import VerificationError


def make_handler(pipeline: RollupPipeline):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print("sequencer: " + fmt % args, file=sys.stderr, flush=True)

        def _send(self, code, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("content-type", ctype)
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/status"):
                self._send(200, json.dumps(pipeline.status()).encode())
            elif self.path.startswith("/rollups"):
                rollups = [{
                    "id": r.id,
                    "dataRoot": r.data_root.hex(),
                    "mined": r.mined,
                    "ethTxHash": r.eth_tx_hash.hex() if r.eth_tx_hash
                                 else None,
                } for r in pipeline.db.get_rollups()]
                self._send(200, json.dumps(rollups).encode())
            elif self.path.startswith("/metrics"):
                self._send(200, pipeline.metrics.expose().encode(),
                           "text/plain; version=0.0.4")
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            length = int(self.headers.get("content-length", 0))
            body = self.rfile.read(length)
            if self.path.startswith("/tx"):
                try:
                    # body = u32 proof_len | proof | viewing keys (2 blobs)
                    import struct as _s

                    if len(body) < 4:
                        raise VerificationError("malformed tx frame")
                    plen = _s.unpack(">I", body[:4])[0]
                    if plen == 0 or 4 + plen > len(body):
                        raise VerificationError("malformed tx frame")
                    proof, vks = body[4:4 + plen], body[4 + plen:]
                    txid = pipeline.tx_receiver.receive_tx(proof, vks)
                    self._send(202, json.dumps({"txId": txid.hex()}).encode())
                except VerificationError as e:
                    self._send(400, json.dumps({"error": str(e)}).encode())
                except Exception as e:
                    self._send(500, json.dumps({"error": repr(e)}).encode())
            elif self.path.startswith("/flush"):
                pipeline.coordinator.flush_txs()
                self._send(200, b'{"ok": true}')
            else:
                self._send(404, b'{"error": "not found"}')

    return Handler


def serve(port: int = 8081, pipeline: RollupPipeline | None = None):
    if pipeline is None:
        proof_url = os.environ.get("AZTEC_PROOF_URL",
                                   "http://127.0.0.1:8082")
        pipeline = RollupPipeline(SequencerConfig(),
                                  HttpProofGenerator(proof_url))
    pipeline.start()
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(pipeline))
    print(f"sequencer listening on :{port}", file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    finally:
        pipeline.stop()


if __name__ == "__main__":
    serve(int(sys.argv[1]) if len(sys.argv) > 1 else 8081)
