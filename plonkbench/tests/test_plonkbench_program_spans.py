"""The readings of the port's own spans (plonkbench/program_spans.py) on a
synthetic Chrome trace: idle gaps cut at the spans' edges, a child counted
once in its parent, the host's blocking calls inside ``prove`` without
``cudaDeviceSynchronize``, null readings without program spans, and the
benchmark's own readers unmoved by the program's ranges."""

import json

import pytest

from plonkbench import program_spans, run
from plonkbench.trace import Trace

READERS = ("device_idle_share", "kernels_per_proof", "k1_device_ms", "glue_device_ms",
           "msm_roofline", "proof_mfu", "witness_ms", "round_ms.quotient",
           "circuit_build_s", "key_s")


def _event(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


BENCH = [
    _event("user_annotation", "plonkbench.window", 0, 1000),
    _event("user_annotation", "plonkbench.witness", 0, 100),
    _event("user_annotation", "plonkbench.round.fourth", 100, 700),
    _event("user_annotation", "plonkbench.msm", 300, 400),
    _event("cuda_runtime", "cudaLaunchKernel", 10, 1, 1),
    _event("cuda_runtime", "cudaLaunchKernel", 150, 1, 2),
    _event("cuda_runtime", "cudaLaunchKernel", 410, 1, 3),
    _event("cuda_runtime", "cudaMemcpyAsync", 540, 1, 4),
    # busy [20, 120), [450, 550), [560, 600); idle (0, 20), (120, 450),
    # (550, 560), (600, 1000)
    _event("kernel", "void elementwise_kernel<float>(...)", 20, 80, 1),
    _event("kernel", "void fk::mont_mul_kernel<16>(int*)", 60, 60, 2),
    _event("kernel", "void gk::proj_add_kernel(int*)", 450, 100, 3),
    _event("gpu_memcpy", "Memcpy DtoH", 560, 40, 4),
    _event("cpu_op", "aten::add", 10, 5),
]
PROGRAM = [
    _event("user_annotation", "aztec_tpu_torch.witness.host", 5, 55),
    _event("user_annotation", "aztec_tpu_torch.prove", 100, 800),
    _event("user_annotation", "aztec_tpu_torch.msm", 320, 370),
    _event("user_annotation", "aztec_tpu_torch.msm.chunk", 330, 170),
    _event("user_annotation", "aztec_tpu_torch.msm.chunk", 520, 80),
    _event("user_annotation", "aztec_tpu_torch.msm.finish", 600, 80),
    _event("cuda_runtime", "cudaStreamSynchronize", 470, 30, 5),
    _event("cuda_runtime", "cudaMemcpy", 700, 15, 6),
    # left out: the benchmark's edges, another thread, outside ``prove``
    _event("cuda_runtime", "cudaDeviceSynchronize", 650, 20, 7),
    _event("cuda_runtime", "cudaEventSynchronize", 710, 10, 8, tid=2),
    _event("cuda_runtime", "cudaStreamSynchronize", 950, 30, 9),
]


def _load(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.from_chrome(str(path)), program_spans.ProgramSpans.from_chrome(str(path))


def test_gaps_are_cut_at_span_edges_and_children_count_once(tmp_path):
    trace, prog = _load(tmp_path, BENCH + PROGRAM)
    # the gap (120, 450) straddles msm's start at 320; (600, 1000) its end at 690
    assert prog.idle_under(trace, "msm") == [(320, 450), (550, 560), (600, 690)]
    assert prog.idle_under(trace, "msm.chunk") == [(330, 450), (550, 560)]
    read = prog.readings(trace)
    assert read["msm_idle_ms"] == pytest.approx(0.230)     # not 0.230 + the children's
    assert read["msm_idle_ms.chunks"] == pytest.approx(0.130)
    assert read["msm_idle_ms.finish"] == pytest.approx(0.080)
    stages = prog.stages(trace)
    assert stages["msm.rest"]["idle_ms"] == pytest.approx(0.020)
    assert (stages["msm"]["kernels"], stages["chunks"]["kernels"]) == (1, 1)
    assert (stages["chunks"]["syncs"], stages["prove.rest"]["syncs"]) == (1, 1)


def test_blocking_calls_inside_prove_without_device_synchronize(tmp_path):
    trace, prog = _load(tmp_path, BENCH + PROGRAM)
    assert [c[0] for c in prog.syncs(trace)] == ["cudaStreamSynchronize", "cudaMemcpy"]
    read = prog.readings(trace)
    assert read["host_syncs_per_proof"] == 2
    assert read["host_wait_ms"] == pytest.approx(0.045)
    assert read["witness_host_ms"] == pytest.approx(0.055)


def test_shared_clock_checks(tmp_path):
    trace, prog = _load(tmp_path, BENCH + PROGRAM)
    checks = prog.checks(trace, run.breakdown(trace))
    assert checks["msm_outside_benchmark_msm"] == 0
    # whole gaps by their start: (320, 450) is cut to 320 at its start, so
    # only those starting inside msm, (550, 560) and (600, 1000), count
    assert checks["msm_idle_s_by_gap_start"] == pytest.approx(410e-6)
    assert checks["breakdown_msm_idle_s"] == pytest.approx(410e-6)
    assert checks["stages_ms"] <= checks["msm_idle_s_traced"] * 1e3
    assert checks["spans_per_proof"]["msm.chunk"] == 2


def test_no_program_spans_reads_null(tmp_path):
    trace, prog = _load(tmp_path, BENCH)
    assert prog.readings(trace) == dict.fromkeys(program_spans.READINGS)
    assert prog.checks(trace, run.breakdown(trace)) == {}


def test_benchmark_readers_unmoved_by_program_spans(tmp_path):
    def read(events):
        trace, _ = _load(tmp_path, events)
        runrec = {"setup": {"circuit_build": 1.5, "key": 2.5},
                  "traced": [{"witness": 0.1, "rounds": {"fourth": 0.7}}],
                  "trace": trace, "subgroup": 1 << 20, "width": 3}
        return {m: run.metric_reader(m)(runrec) for m in READERS}, run.breakdown(trace)
    assert read(BENCH + PROGRAM) == read(BENCH)
