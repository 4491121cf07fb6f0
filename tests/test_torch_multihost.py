"""The port's multi-process sharded MSM (aztec_tpu_torch/parallel/
multihost.py) on the CPU: two gloo processes of two shards each over 32
points of the committed table, the engine on every shard; process 0 holds
the folded result to the single-device MSM and to the port's host golden
(sum k_i tau^i) G, and ``launch`` reports it; the point it prints equals
aztec_tpu's pure-Python golden curve at its dev SRS's tau."""

import re
import time

from aztec_tpu.curves.golden import GoldenCurve
from aztec_tpu.curves.spec import BN254_G1
from aztec_tpu.srs.reference_string import FakeReferenceStringFactory
from aztec_tpu_torch.parallel import multihost


def test_two_processes_two_shards_each(monkeypatch, capsys):
    # narrow planes: one thread a process is the CPU's fastest
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    t0 = time.perf_counter()
    ok = multihost.launch(n=32, device="cpu", config=(4, 4, 4, True),
                          timeout_s=120)
    assert ok, "multihost run failed"
    assert time.perf_counter() - t0 < 120
    m = re.search(r"MULTIHOST OK (0x[0-9a-f]+) (0x[0-9a-f]+)",
                  capsys.readouterr().out)
    assert m, "process 0 printed no point"
    _, _, ks = multihost._inputs(32, "cpu")
    tau, r = FakeReferenceStringFactory().tau, BN254_G1.order
    kk = sum(k * pow(tau, i, r) for i, k in enumerate(ks)) % r
    expect = GoldenCurve(BN254_G1).mul(kk, (BN254_G1.gen_x, BN254_G1.gen_y))
    assert (int(m[1], 16), int(m[2], 16)) == expect


def test_launch_fails_on_timeout():
    assert not multihost.launch(n=32, device="cpu", config=(4, 4, 4, True),
                                timeout_s=1)
