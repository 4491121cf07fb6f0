"""HTTP proof service wrapping the proof worker subprocess.

The halloumi proof server (halloumi/src/server.ts:
42, proof_generator/cli_proof_generator.ts:53-90): the HTTP layer owns a
long-lived worker child process (rollup_cli analog, serving/proof_worker.py)
speaking the length-prefixed big-endian binary protocol over pipes, with a
serial execution queue (one proof at a time — the device is the bottleneck)
and a reset that restarts the child.

Endpoints:
  GET  /status                  -> {"ready": true|false}
  POST /create-proof            -> proof bytes (request body = u32 proof_id
                                   big-endian + request payload, exactly the
                                   worker protocol frame)
  POST /reset                   -> restart the worker
  GET  /get-join-split-vk       -> the join-split VK JSON (worker id 0x200)
  GET  /get-account-vk          -> the account VK JSON (worker id 0x201)

Run: python -m aztec_tpu_torch.serving.http_server [port]

Port of aztec_tpu/serving/http_server.py: its worker child is the port's
``python -u -m aztec_tpu_torch.serving.proof_worker``, which proves on the
card.
"""

from __future__ import annotations

import json
import struct
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class WorkerClient:
    """Owns the proof-worker child process; serialized createProof."""

    def __init__(self, argv=None):
        self.argv = argv or [sys.executable, "-u", "-m",
                             "aztec_tpu_torch.serving.proof_worker"]
        self.lock = threading.Lock()
        self.proc = None
        self.ready = False

    def start(self):
        with self.lock:
            self._start_locked()

    def _start_locked(self):
        self.proc = subprocess.Popen(
            self.argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=sys.stderr,
        )
        ready = self.proc.stdout.read(1)
        self.ready = ready == b"\x01"

    def stop(self):
        with self.lock:
            if self.proc:
                self.proc.kill()
                self.proc.wait()
                self.proc = None
            self.ready = False

    def reset(self):
        """halloumi Server.reset(): restart the child (server.ts:46-49)."""
        with self.lock:
            if self.proc:
                self.proc.kill()
                self.proc.wait()
            self._start_locked()

    def create_proof(self, frame: bytes) -> bytes:
        """frame = u32 proof_id BE + payload; returns proof bytes.

        Raises RuntimeError if the worker reports the proof invalid."""
        with self.lock:
            if not self.ready:
                raise RuntimeError("worker not ready")
            p = self.proc
            p.stdin.write(frame)
            p.stdin.flush()
            header = p.stdout.read(4)
            if len(header) < 4:
                raise RuntimeError("worker died")
            length = struct.unpack(">I", header)[0]
            data = p.stdout.read(length + 1)
            if len(data) < length + 1:
                raise RuntimeError("worker died mid-proof")
            if data[length] != 1:
                raise RuntimeError("proof invalid")
            return data[:length]


def make_handler(worker: WorkerClient):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print("http: " + fmt % args, file=sys.stderr, flush=True)

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/octet-stream"):
            self.send_response(code)
            self.send_header("content-type", ctype)
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/status"):
                self._send(200, json.dumps({"ready": worker.ready}).encode(),
                           "application/json")
            elif self.path.startswith("/get-join-split-vk"):
                # (halloumi app.ts:53-57)
                try:
                    vk = worker.create_proof(struct.pack(">I", 0x200))
                    self._send(200, vk, "application/json")
                except Exception as e:
                    self._send(500, str(e).encode(), "text/plain")
            elif self.path.startswith("/get-account-vk"):
                # (halloumi app.ts:59-63)
                try:
                    vk = worker.create_proof(struct.pack(">I", 0x201))
                    self._send(200, vk, "application/json")
                except Exception as e:
                    self._send(500, str(e).encode(), "text/plain")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            length = int(self.headers.get("content-length", 0))
            body = self.rfile.read(length)
            if self.path.startswith("/create-proof"):
                try:
                    proof = worker.create_proof(body)
                    self._send(200, proof)
                except Exception as e:  # serving layer: report, don't die
                    self._send(400, str(e).encode(), "text/plain")
            elif self.path.startswith("/reset"):
                worker.reset()
                self._send(200, b"ok", "text/plain")
            else:
                self._send(404, b"not found")

    return Handler


def serve(port: int = 8082, worker: WorkerClient | None = None):
    worker = worker or WorkerClient()
    worker.start()
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(worker))
    print(f"proof server listening on :{port}", file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    finally:
        worker.stop()


if __name__ == "__main__":
    serve(int(sys.argv[1]) if len(sys.argv) > 1 else 8082)
