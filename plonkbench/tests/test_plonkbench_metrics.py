"""The metric arithmetic: the rate over the whole window, the 90th
percentile over every request, and the trace's shares from a union of
intervals, on a synthetic Chrome trace."""

import json

import pytest

from plonkbench import run, work
from plonkbench.trace import Trace, symbol


def test_rate_and_tail_over_the_whole_window():
    lat = [1.0] * 8 + [2.0, 3.0]
    m = run.end_to_end_values(lat, failed=1, window_s=12.0, setup_s=20.0, peak=2**31)
    assert m["proofs_per_s"]["value"] == pytest.approx(9 / 12.0)
    assert m["proof_p90_s"]["value"] == 2.0      # rank ceil(0.9 * 10) = 9
    assert m["peak_device_gib"]["value"] == 2.0
    assert m["setup_s"]["value"] == 20.0


@pytest.mark.parametrize("values,want", [([5.0], 5.0), (list(range(1, 21)), 18),
                                         (list(range(1, 31)), 27)])
def test_nearest_rank_is_a_sample(values, want):
    assert run.nearest_rank(values, 0.9) == want


def _event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def trace(tmp_path):
    events = [
        _event("user_annotation", "plonkbench.window", 0, 1000),
        _event("user_annotation", "plonkbench.witness", 0, 100),
        _event("user_annotation", "plonkbench.round.fourth", 100, 700),
        _event("user_annotation", "plonkbench.msm", 400, 300),
        _event("cuda_runtime", "cudaLaunchKernel", 10, 1, 1),
        _event("cuda_runtime", "cudaLaunchKernel", 150, 1, 2),
        _event("cuda_runtime", "cudaLaunchKernel", 410, 1, 3),
        _event("cuda_runtime", "cudaLaunchKernel", 420, 1, 4),
        # overlapping ops merge into one busy interval: [20, 120)
        _event("kernel", "void elementwise_kernel<float>(...)", 20, 80, 1),
        _event("kernel", "void fk::mont_mul_kernel<16>(int*)", 60, 60, 2),
        _event("kernel", "void gk::proj_add_kernel(int*)", 450, 100, 3),
        _event("gpu_memcpy", "Memcpy DtoH", 560, 40, 4),
        _event("cpu_op", "aten::add", 10, 5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.from_chrome(str(path))


def test_union_of_intervals_and_idle_gaps(trace):
    assert trace.busy_intervals() == [(20, 120), (450, 550), (560, 600)]
    assert trace.idle_gaps() == [(0, 20), (120, 450), (550, 560), (600, 1000)]
    assert trace.open_span(130) == "round.fourth"
    assert trace.open_span(500) == "msm"
    assert trace.open_span(5) == "witness"
    assert [o[0] for o in trace.launched_within("msm")] == [
        "void gk::proj_add_kernel(int*)", "Memcpy DtoH"]


def test_readers_on_the_trace(trace):
    runrec = {"setup": {"circuit_build": 1.5, "key": 2.5},
              "traced": [{"witness": 0.1, "rounds": {"fourth": 0.7}}],
              "trace": trace, "subgroup": 1 << 20, "width": 3}
    read = {m: run.metric_reader(m)(runrec) for m in (
        "device_idle_share", "kernels_per_proof", "k1_device_ms", "glue_device_ms",
        "msm_roofline", "proof_mfu", "witness_ms", "round_ms.quotient",
        "circuit_build_s", "key_s")}
    assert read["device_idle_share"] == pytest.approx(1 - 240 / 1000)
    assert read["kernels_per_proof"] == 3
    assert read["k1_device_ms"] == pytest.approx(0.060)
    assert read["glue_device_ms"] == pytest.approx(0.120)   # elementwise + memcpy
    least = 9 * work.msm_seconds(1 << 20)
    assert read["msm_roofline"] == pytest.approx(100 * least / 140e-6)
    assert read["proof_mfu"] == pytest.approx(100 * work.proof_seconds(3, 1 << 20) / 1e-3)
    assert read["witness_ms"] == pytest.approx(100)
    assert read["round_ms.quotient"] == pytest.approx(700)
    assert (read["circuit_build_s"], read["key_s"]) == (1.5, 2.5)


def test_breakdown_names_gaps_by_the_open_span(trace):
    b = run.breakdown(trace)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    gaps = dict(b["idle_gaps"])
    # a gap is named by the innermost span open on the host at its start
    assert gaps == pytest.approx({"witness": 20e-6, "round.fourth": 330e-6,
                                  "msm": 410e-6})
    assert "mont_mul_kernel" in dict(b["device_ops"])


def test_kernel_symbols():
    assert symbol("void fk::fft_stages_kernel<3>(...)") == "fft_stages_kernel"
    assert symbol("void at::native::vectorized_elementwise_kernel<4>(...)") is None


def test_least_work_counts():
    # 2^20 points: 16 windows of 2^20 additions and 16 reductions of 2^17
    adds = 16 * (1 << 20) + 16 * (1 << 17)
    assert work.msm_seconds(1 << 20) == pytest.approx(
        adds * 11 * 264 / work.PEAK_INT32_MAD_PER_S)
    assert work.proof_msms(3) == 9 and work.proof_msms(4) == 11
