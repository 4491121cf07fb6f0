"""The port's sequencer (aztec_tpu_torch.sequencer) against aztec_tpu's, on
the CPU.

One script of txs drives both packages' pipelines, each over a mock of the
proof worker (halloumi's stand-in): the reference's own
``tests/test_sequencer.MockProofGenerator`` for aztec_tpu, and the port's
copy below, which reads the frames with the port's ``rollup.serialize``.
The script has full batches, a flush of a partial batch, a fee surplus
that publishes at once, an injected proof failure and its recovery, and a
rollup the chain rejects.  Held byte for byte: every frame sent to the
generator (ids 0 and 1), the world-state roots after each tick, and each
settled block (its id, hash, proof, ``tx_datas``, ``data_start_index`` and
viewing keys; the timestamps left out).  Held equal: the db's pending,
unsettled and rollup counts, the ``status()`` keys and values
(``nextPublishTime`` left out) and the ``/metrics`` exposition (the
histograms' sums of seconds by name only).  The tx receiver's rejections
and the HTTP handler's answers (in process, on a free local port) are
held to the reference's words.  No circuit is proved here: chip_smoke.py
phase 5d runs the port's pipeline against the port's worker on the card.
"""

import http.client
import json
import random
import struct
import threading
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from aztec_tpu_torch.rollup.constants import NUM_ASSETS
from aztec_tpu_torch.rollup.inner_proof_data import InnerProofFields
from aztec_tpu_torch.rollup.serialize import (read_root_rollup_tx,
                                              read_rollup_tx)

F = InnerProofFields
SEED = 20261018


def make_tx_proof(ws, n1: int, n2: int, fee: int = 10) -> bytes:
    """Structurally-valid tx proof: 14 public-input fields + opaque tail
    (tests/test_sequencer.py's)."""
    fields = [0] * F.NUM_FIELDS
    fields[F.PROOF_ID] = 0
    fields[F.NEW_NOTE1_X] = 0x1111 + n1
    fields[F.NEW_NOTE1_Y] = 0x2222 + n1
    fields[F.NEW_NOTE2_X] = 0x3333 + n2
    fields[F.NEW_NOTE2_Y] = 0x4444 + n2
    fields[F.NULLIFIER1] = n1
    fields[F.NULLIFIER2] = n2
    fields[F.MERKLE_ROOT] = ws.data_root()
    fields[F.TX_FEE] = fee
    return b"".join(v.to_bytes(32, "big") for v in fields) + b"\xAA" * 64


def _parse_mock_inner(proof: bytes) -> dict:
    f = lambda i: int.from_bytes(proof[i * 32:(i + 1) * 32], "big")  # noqa: E731
    size = f(1)
    base = 8 * 32
    return {
        "size": size, "start": f(2), "old_data_root": f(3),
        "new_data_root": f(4), "old_null_root": f(5), "new_null_root": f(6),
        "txs": proof[base:base + size * F.NUM_PUBLISHED * 32],
    }


class MockProofGenerator:
    """halloumi stand-in: echoes structurally-valid rollup proofs (the
    port's copy of tests/test_sequencer.py's, over the port's
    serialization).  ``frames`` holds every request it was sent."""

    def __init__(self):
        self.frames = []
        self.fail_next = 0

    def create_proof(self, frame: bytes) -> bytes:
        proof_id = struct.unpack(">I", frame[:4])[0]
        self.frames.append(frame)
        if self.fail_next > 0:
            self.fail_next -= 1
            raise RuntimeError("injected proof failure")
        if proof_id == 0:
            num_txs = struct.unpack(">I", frame[4:8])[0]
            blen = struct.unpack(">I", frame[8:12])[0]
            tx = read_rollup_tx(frame[12:12 + blen])
            fields = [0, num_txs, tx.data_start_index, tx.old_data_root,
                      tx.new_data_root, tx.old_null_root,
                      tx.new_null_roots[-1], tx.data_roots_root]
            slots = list(tx.txs) + [b""] * (num_txs - len(tx.txs))
            tail = b"".join(p[:F.NUM_PUBLISHED * 32].ljust(
                F.NUM_PUBLISHED * 32, b"\0") for p in slots)
            return (b"".join(v.to_bytes(32, "big") for v in fields)
                    + tail + b"\xBB" * 32)
        if proof_id == 1:
            off = 12
            vlen = struct.unpack(">I", frame[off:off + 4])[0]
            off += 4 + vlen
            blen = struct.unpack(">I", frame[off:off + 4])[0]
            tx = read_root_rollup_tx(frame[off + 4:off + 4 + blen])
            inners = [_parse_mock_inner(p) for p in tx.rollups]
            first, last = inners[0], inners[-1]
            total_size = sum(i["size"] for i in inners)
            head = [tx.rollup_id, total_size, first["start"],
                    first["old_data_root"], last["new_data_root"],
                    first["old_null_root"], last["new_null_root"],
                    tx.old_data_roots_root, tx.new_data_roots_root]
            head += [0] * NUM_ASSETS + [len(inners)]
            txs_tail = b"".join(i["txs"] for i in inners)
            return (b"".join(v.to_bytes(32, "big") for v in head)
                    + txs_tail + b"\xDD" * 32)
        raise ValueError(proof_id)

    def reset(self):
        pass


class _Recorder:
    """Records the frames sent to the reference's own mock."""

    def __init__(self, gen):
        self.gen = gen
        self.frames = []

    @property
    def fail_next(self):
        return self.gen.fail_next

    @fail_next.setter
    def fail_next(self, n):
        self.gen.fail_next = n

    def create_proof(self, frame: bytes) -> bytes:
        self.frames.append(frame)
        return self.gen.create_proof(frame)

    def reset(self):
        self.gen.reset()


def _side(pkg: str) -> SimpleNamespace:
    import importlib

    mod = lambda name: importlib.import_module(pkg + name)  # noqa: E731
    if pkg == "aztec_tpu":
        from test_sequencer import MockProofGenerator as RefMock

        make_gen = lambda: _Recorder(RefMock())  # noqa: E731
    else:
        make_gen = MockProofGenerator
    return SimpleNamespace(
        pipeline=mod(".sequencer.rollup_pipeline"),
        chain=mod(".sequencer.blockchain"),
        server=mod(".sequencer.server"),
        receiver=mod(".sequencer.tx_receiver"),
        db=mod(".sequencer.rollup_db"),
        make_gen=make_gen)


SIDES = ("aztec_tpu_torch", "aztec_tpu")


def make_pipeline(side: SimpleNamespace, **cfg):
    config = side.pipeline.SequencerConfig(publish_interval_s=1000.0, **cfg)
    gen = side.make_gen()
    chain = side.chain.LocalBlockchain()
    return side.pipeline.RollupPipeline(config, gen, blockchain=chain), gen


def _viewing_keys(rng: random.Random) -> bytes:
    return rng.randbytes(2 * (64 + 80))


def _state(p, gen, ticked) -> dict:
    ws = p.world_state
    return {
        "ticked": ticked,
        "frames": list(gen.frames),
        "roots": (ws.data_root(), ws.null_tree.root, ws.root_tree.root,
                  ws.data_tree_next_index),
        "counts": (p.db.get_pending_tx_count(),
                   p.db.get_unsettled_tx_count(),
                   p.db.get_next_rollup_id(), len(p.db.get_rollups(100))),
        "blocks": [(b.rollup_id, b.tx_hash, b.rollup_proof_data,
                    b.data_start_index, b.tx_datas, b.viewing_keys)
                   for b in p.blockchain.get_blocks(0)],
    }


def run_script(pkg: str) -> tuple:
    """The scripted run on one package: a list of states, one a tick, and
    the pipeline at its end."""
    side = _side(pkg)
    p, gen = make_pipeline(side, num_inner_rollup_txs=2,
                           num_outer_rollup_proofs=2, data_tree_depth=5,
                           null_tree_depth=8, root_tree_depth=3)
    rng = random.Random(SEED)
    rx, coord = p.tx_receiver, p.coordinator
    states = []

    def submit(*pairs, fee=10):
        for n1, n2 in pairs:
            rx.receive_tx(make_tx_proof(p.world_state, n1, n2, fee),
                          _viewing_keys(rng))

    def tick():
        states.append(_state(p, gen, coord.tick()))

    submit((1, 2))
    tick()                                   # the first rollup: at once
    submit((3, 4), (5, 6), (7, 8), (9, 10))
    tick()                                   # a full outer rollup
    submit((11, 12))
    tick()                                   # waits (no surplus)
    coord.flush_txs()
    tick()                                   # a flushed partial batch
    submit((13, 14), fee=20)
    tick()                                   # a fee surplus: at once
    submit((15, 16))
    gen.fail_next = 1
    coord.flush_txs()
    tick()                                   # the worker fails: reset
    coord.flush_txs()
    tick()                                   # replayed
    submit((17, 18))
    p.blockchain.verify_proof = lambda proof: False
    coord.flush_txs()
    tick()                                   # the chain rejects: reset
    p.blockchain.verify_proof = lambda proof: True
    coord.flush_txs()
    tick()                                   # replayed
    return states, p


@pytest.fixture(scope="module")
def scripted():
    return {pkg: run_script(pkg) for pkg in SIDES}


def test_script_ticks_as_the_reference(scripted):
    port, ref = scripted["aztec_tpu_torch"][0], scripted["aztec_tpu"][0]
    assert [s["ticked"] for s in port] == [True, True, False, True, True,
                                           False, True, False, True]
    assert [s["ticked"] for s in port] == [s["ticked"] for s in ref]
    assert [s["counts"] for s in port] == [s["counts"] for s in ref]
    assert port[-1]["counts"] == (0, 0, 6, 6)


def test_frames_byte_for_byte(scripted):
    port, ref = scripted["aztec_tpu_torch"][0], scripted["aztec_tpu"][0]
    frames = port[-1]["frames"]
    ids = [struct.unpack(">I", f[:4])[0] for f in frames]
    # rollups 0-5: one inner proof, two, then one each (the failed id 0
    # and the rejected rollup's two requests are sent again)
    assert ids == [0, 1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 1, 0, 1, 0, 1]
    assert frames == ref[-1]["frames"]
    for s, r in zip(port, ref):
        assert s["frames"] == r["frames"]


def test_world_state_roots_each_tick(scripted):
    port, ref = scripted["aztec_tpu_torch"][0], scripted["aztec_tpu"][0]
    assert [s["roots"] for s in port] == [s["roots"] for s in ref]
    # the failed tick and the rejected one leave the roots as they were
    assert port[5]["roots"] == port[4]["roots"]
    assert port[7]["roots"] == port[6]["roots"]


def test_blocks_byte_for_byte(scripted):
    port, ref = scripted["aztec_tpu_torch"][0], scripted["aztec_tpu"][0]
    blocks = port[-1]["blocks"]
    assert [b[0] for b in blocks] == [0, 1, 2, 3, 4, 5]
    assert [len(b[4]) for b in blocks] == [1, 4, 1, 1, 1, 1]
    assert all(len(vk) == 2 for b in blocks for vk in b[5])
    assert blocks == ref[-1]["blocks"]


def test_status_and_metrics(scripted):
    port, ref = scripted["aztec_tpu_torch"][1], scripted["aztec_tpu"][1]
    s, r = port.status(), ref.status()
    assert set(s) == set(r)
    s.pop("nextPublishTime")
    r.pop("nextPublishTime")
    assert s == r

    def lines(p):
        out = []
        for line in p.metrics.expose().splitlines():
            name, _, value = line.rpartition(" ")
            out.append(name if name.endswith("_sum") else line)
        return out

    assert lines(port) == lines(ref)
    assert 'tx_received_total{type="0"} 9.0' in lines(port)
    assert "rollup_published_total 6.0" in lines(port)


# -- admission ---------------------------------------------------------------

@pytest.fixture(scope="module")
def receivers():
    """Both packages' pipelines at small depths, one tx admitted."""
    out = {}
    for pkg in SIDES:
        p, _ = make_pipeline(_side(pkg), data_tree_depth=3,
                             null_tree_depth=6, root_tree_depth=2)
        good = make_tx_proof(p.world_state, 5, 6)
        assert p.tx_receiver.receive_tx(good) == _side(pkg).db.tx_id(good)
        out[pkg] = (p, good)
    return out


def _bad_root(ws):
    proof = bytearray(make_tx_proof(ws, 11, 12))
    proof[F.MERKLE_ROOT * 32:(F.MERKLE_ROOT + 1) * 32] = b"\x07" * 32
    return bytes(proof)


ADMISSION = {
    "insufficient fee": lambda ws, good: make_tx_proof(ws, 8, 9, fee=1),
    "unknown data root": lambda ws, good: _bad_root(ws),
    "duplicate tx": lambda ws, good: good,
    "duplicate nullifier in tx":
        lambda ws, good: make_tx_proof(ws, 10, 10),
    "nullifier already used": lambda ws, good: make_tx_proof(ws, 5, 7),
    "proof verification failed":
        lambda ws, good: make_tx_proof(ws, 13, 14),
}


@pytest.mark.parametrize("words", list(ADMISSION))
def test_tx_receiver_refuses_in_the_reference_words(receivers, words):
    said = {}
    for pkg, (p, good) in receivers.items():
        proof = ADMISSION[words](p.world_state, good)
        rx = p.tx_receiver
        if words == "proof verification failed":
            rx.verify_proof = lambda proof: False
        try:
            with pytest.raises(_side(pkg).receiver.VerificationError) as e:
                rx.receive_tx(proof)
        finally:
            rx.verify_proof = lambda proof: True
        said[pkg] = str(e.value)
        assert p.db.get_pending_tx_count() == 1
    assert said["aztec_tpu_torch"] == said["aztec_tpu"] == words


# -- the HTTP handler ----------------------------------------------------------

def _http(port: int, method: str, path: str, body: bytes = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _serve_session(pkg: str) -> list:
    """The handler's answers to a session of requests, in process."""
    side = _side(pkg)
    p, _ = make_pipeline(side, num_inner_rollup_txs=1,
                         num_outer_rollup_proofs=1, data_tree_depth=3,
                         null_tree_depth=6, root_tree_depth=2)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                side.server.make_handler(p))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    proof = make_tx_proof(p.world_state, 1, 2)
    vks = _viewing_keys(random.Random(SEED))
    frame = struct.pack(">I", len(proof)) + proof + vks
    out = []
    try:
        code, body = _http(port, "GET", "/status")
        status = json.loads(body)
        status.pop("nextPublishTime")
        out.append(("status", code, status))
        for name, body in (("tx", frame), ("tx again", frame),
                           ("short", b"\0\0"),
                           ("empty", struct.pack(">I", 0) + proof),
                           ("long", struct.pack(">I", len(proof) + 1)
                            + proof)):
            code, answer = _http(port, "POST", "/tx", body)
            out.append((name, code, json.loads(answer)))
        out.append(("flush",) + _http(port, "POST", "/flush", b""))
        out.append(("ticked", p.coordinator.tick()))
        code, body = _http(port, "GET", "/rollups")
        rollups = json.loads(body)
        mined = [r.pop("mined") for r in rollups]
        out.append(("rollups", code, rollups, [m is not None for m in mined]))
        code, body = _http(port, "GET", "/metrics")
        text = [line for line in body.decode().splitlines()
                if not line.split(" ")[0].endswith("_sum")]
        out.append(("metrics", code, text))
        out.append(("nope",) + _http(port, "GET", "/nope"))
        out.append(("post nope",) + _http(port, "POST", "/nope", b""))
        out.append(("blocks", [(b.tx_datas, b.viewing_keys)
                               for b in p.blockchain.get_blocks(0)]))
        out.append(("sent", proof, vks))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    return out


def test_http_handler_answers_as_the_reference():
    port, ref = _serve_session("aztec_tpu_torch"), _serve_session("aztec_tpu")
    assert port == ref
    got = {entry[0]: entry[1:] for entry in port}
    proof, vks = got["sent"]
    db = _side("aztec_tpu_torch").db
    assert got["tx"] == (202, {"txId": db.tx_id(proof).hex()})
    assert got["tx again"] == (400, {"error": "duplicate tx"})
    for name in ("short", "empty", "long"):
        assert got[name] == (400, {"error": "malformed tx frame"})
    assert got["flush"] == (200, b'{"ok": true}')
    assert got["ticked"] == (True,)
    assert got["rollups"][0] == 200 and got["rollups"][2] == [True]
    assert got["nope"][0] == got["post nope"][0] == 404
    assert got["blocks"] == ([([proof], [[vks[:144], vks[144:]]])],)
    assert "pending_txs 1.0" in got["metrics"][1]
