"""Run one cell of the benchmark once.

    python -m plonkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards.  A
run sets up (imports, the configuration's circuit from the seed, the proving
and verification keys, the mix's warm-up proofs), then serves the traffic mix
for ``--seconds``: each request calls the composer's ``create_prover()`` (the
witness planes; ``create_unrolled_prover()`` where the configuration's
``prover`` is ``unrolled``) and ``construct_proof()`` with the prover's random
source drawn from the seed and the request's index, and ends with the proof's
bytes on the host.  Where the configuration's circuit module draws an input
for each request (``circuits/``), the request's input is drawn before its
clock starts and the drawing's seconds are left out of the window; the
request then builds its own circuit and proving key before its prover.
Once the window has closed and the device's peak memory is read, the plain
reference (``reference/``) works out the verification key from the set-up
circuit's gates and checks every proof of the window: that it verifies, that
it carries its request's public inputs, that its wire commitments are those
of its own witness under its own request's blinding, and that its circuit
has the set-up circuit's selectors and copy cycles.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit).
With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` some of the window's requests run under torch.profiler and the
metrics are the cell's per-layer metrics (``metrics/<name>.py`` each).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "aztec_tpu")
ROUNDS = ("preamble", "first", "second", "third", "fourth", "fifth", "sixth")

# keep every build and kernel cache inside the checkout, at fixed paths
# (the port's own nvcc builds go to build/aztec_tpu_torch there already)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ["USE_FLAX"] = "0"

from plonkbench import seeds  # noqa: E402
from plonkbench.reference import bn254, keys, verifier  # noqa: E402
from plonkbench.reference.transcript import Transcript  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(name: str, bench_path: str = os.path.join(ROOT, "BENCHMARK.json")):
    """(cell, config, mix, end-to-end metric names, per-layer metric names)
    of the workload ``name``, found by the names in ``BENCHMARK.json``."""
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry, = [c for c in bench["configs"] if c["name"] == cell["config"]]
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)

    def names(kind):
        return [m["name"] for m in bench[kind]
                if name in m.get("workloads", [name])]
    return cell, config, mix, names("end_to_end"), names("per_layer")


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"plonkbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """The benchmark's host spans of a traced request: seconds by name, the
    device synchronised at each edge, and a ``record_function`` range of the
    same name in the profiler's trace."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds: dict = {}
        self._open = None

    def start(self, name: str) -> None:
        import torch

        self.stop()
        self.sync()
        rf = torch.profiler.record_function("plonkbench." + name)
        rf.__enter__()
        self._open = (name, rf, time.perf_counter())

    def stop(self) -> None:
        if self._open is None:
            return
        name, rf, t0 = self._open
        self.sync()
        self.seconds[name] = time.perf_counter() - t0
        rf.__exit__(None, None, None)
        self._open = None


@contextlib.contextmanager
def msm_span():
    """A ``plonkbench.msm`` range around each batched MSM of the work queue
    (``aztec_tpu_torch.plonk.proving_key.commit_scalars``)."""
    import torch
    from aztec_tpu_torch.plonk import proving_key

    original = proving_key.commit_scalars

    def commit_scalars(*args, **kwargs):
        with torch.profiler.record_function("plonkbench.msm"):
            return original(*args, **kwargs)
    proving_key.commit_scalars = commit_scalars
    try:
        yield
    finally:
        proving_key.commit_scalars = original


def prover_method(config: dict) -> str:
    return "create_unrolled_prover" if config.get("prover") == "unrolled" else "create_prover"


def serve(composer, rng, spans: Spans | None = None, make: str = "create_prover") -> bytes:
    """One request: the witness planes, then the proof's bytes."""
    if spans is None:
        prover = getattr(composer, make)()
        prover.rng = rng
        return prover.construct_proof()
    spans.start("witness")
    prover = getattr(composer, make)()
    spans.stop()
    for r in ROUNDS:
        method = getattr(prover, f"execute_{r}_round")

        def timed(r=r, method=method):
            spans.start("round." + r)
            return method()
        setattr(prover, f"execute_{r}_round", timed)
    prover.rng = rng
    proof = prover.construct_proof()
    spans.stop()
    for r in ROUNDS:   # the wrappers refer to the prover: free it with the frame
        delattr(prover, f"execute_{r}_round")
    return proof


def serve_input(circuit, config: dict, tx, device: str, setup, rng,
                spans: Spans | None = None) -> tuple:
    """One request that carries its own input: its circuit, its proving
    key, then its proof.  Returns (proof bytes, the request's composer)."""
    if spans is not None:
        spans.start("circuit")
    composer = circuit.build_request(config, tx, device, setup)
    if spans is not None:
        spans.start("key")
    composer.compute_proving_key()
    return serve(composer, rng, spans, prover_method(config)), composer


def nearest_rank(values: list, q: float) -> float:
    """The q-quantile of ``values`` by nearest rank: a sample, not a blend."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def end_to_end_values(latencies: list, failed: int, window_s: float,
                      setup_s: float, peak: int) -> dict:
    """The end-to-end metrics of a window: the proofs that passed the check
    over all of the window's seconds, the 90th percentile of every request's
    latency, the device's peak and the set-up."""
    return {
        "proofs_per_s": {"value": (len(latencies) - failed) / window_s, "unit": "proofs/s"},
        "proof_p90_s": {"value": nearest_rank(latencies, 0.9), "unit": "s"},
        "peak_device_gib": {"value": peak / 2**30, "unit": "GiB"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "nvidia-smi gave nothing"


def check_proofs(config, seed: int, composer, vk, records: list) -> dict:
    """The plain reference's comparison, after the window: counts that are
    each held to the limit 0.  Marks each record's ``ok``.  A record that
    carries its own ``circuit`` and ``public`` inputs is held to them;
    every other to the set-up circuit's."""
    mod = importlib.import_module(f"plonkbench.circuits.{config['circuit']}")
    ref = mod.reference(config, seed, composer)
    flavor = verifier.for_config(config)
    per_request = hasattr(mod, "draw")
    comms, n, lagrange = keys.verification_key(ref, keys.DEV_TAU)
    vk_mismatch = sum(vk.commitments.get(label) != pt for label, pt in comms.items())
    vk_mismatch += (vk.n != n) + (vk.num_public_inputs != len(ref.public_inputs))
    base = keys.wire_evaluations(ref, lagrange)
    public_ref = ref.public_values()
    shape = keys.shape(ref) if per_request else None
    rejected = wrong_public = wrong_wires = raised = differs = 0
    for rec in records:
        proof = rec.get("proof")
        if proof is None:
            raised += 1
            rec["ok"] = False
            continue
        own = rec.get("circuit")
        public = public_ref if own is None else rec["public"]
        same = own is None or keys.same_shape(shape, keys.shape(own))
        ok = verifier.verify(proof, flavor, n, len(public), comms, keys.DEV_TAU)
        pub_ok = ok and verifier.public_inputs(proof, flavor, len(public)) == public
        wires_ok = False
        if ok:
            t = Transcript(flavor.manifest(len(public)), proof, flavor.hash)
            want = keys.wire_commitments(
                base if own is None else keys.wire_evaluations(own, lagrange),
                seeds.blinding_values(seed, rec["index"], flavor.width,
                                      keys.BLINDED_ROWS), lagrange)
            wires_ok = all(bn254.g1_from_bytes(t.elements[f"W_{i + 1}"]) == (True, w)
                           for i, w in enumerate(want))
        rejected += not ok
        wrong_public += ok and not pub_ok
        wrong_wires += ok and not wires_ok
        differs += not same
        rec["ok"] = ok and pub_ok and wires_ok and same
    counts = {"vk_mismatch": vk_mismatch, "requests_raised": raised,
              "proofs_rejected": rejected, "public_inputs_wrong": wrong_public,
              "wires_wrong": wrong_wires}
    if per_request:
        publics = [tuple(rec["public"]) for rec in records]
        counts["circuit_differs"] = differs
        counts["tx_repeated"] = len(publics) - len(set(publics))
    return counts


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: str = "none", cell_data=None) -> dict:
    """Set up, serve the window, check; returns the result's fields.
    ``cell_data``: what ``load_cell(name)`` reads, or a test's small cell;
    ``control`` = ``stale_blinding`` serves every request with the
    random source of request 0, ``stale_tx`` every request with request 0's
    input (the controls of the comparison)."""
    import torch

    cell, config, mix, end_to_end, per_layer = cell_data or load_cell(name)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    circuit = importlib.import_module(f"plonkbench.circuits.{config['circuit']}")
    per_request = hasattr(circuit, "draw")
    if control == "stale_tx" and not per_request:
        raise ValueError(f"{config['circuit']}: its requests carry no input of their own")
    make = prover_method(config)

    setup = {}
    t0 = time.perf_counter()
    composer = circuit.build(config, seed, device)
    setup["circuit_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    composer.compute_proving_key()
    vk = composer.compute_verification_key()
    sync()
    setup["key"] = time.perf_counter() - t0
    for i in range(mix["warmup_requests"]):
        rng = seeds.blinding(seed, -1 - i)
        if per_request:
            tx, _ = circuit.draw(config, seed, -1 - i)
            serve_input(circuit, config, tx, device, composer, rng)
        else:
            serve(composer, rng, make=make)
    sync()
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s: circuit {setup['circuit_build']:.3f}, "
        f"keys {setup['key']:.3f}, {mix['warmup_requests']} warm-up proofs")

    if mix["loop"] != "closed" or mix["clients"] != 1 or mix["outstanding"] != 1:
        raise ValueError(f"mix {cell['traffic']}: only one closed-loop client is served")
    traced_ids = range(1, 1 + mix["traced_requests"]) if trace else range(0)
    records, traced, prof = [], [], None
    pending, first_tx, drawn_s = {}, None, 0.0
    t_open = time.perf_counter()
    index = 0
    while (index == 0 or time.perf_counter() - t_open - drawn_s < seconds
           or index <= traced_ids.stop - 1):
        rec = {"index": index}
        if per_request:
            if index not in pending:   # the traced requests' inputs before the trace
                t0 = time.perf_counter()
                for i in traced_ids if index in traced_ids else (index,):
                    pending[i] = circuit.draw(config, seed, i)
                drawn_s += time.perf_counter() - t0
            tx, rec["public"] = pending.pop(index)
            if control == "stale_tx":
                if first_tx is None:
                    first_tx = tx
                tx = first_tx
        rng = seeds.blinding(seed, 0 if control == "stale_blinding" else index)
        spans = own = None
        if index in traced_ids:
            if prof is None:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                window = torch.profiler.record_function("plonkbench.window")
                window.__enter__()
                msm = msm_span()
                msm.__enter__()
            spans = Spans(sync)
        rec["start"] = time.perf_counter()
        try:
            if per_request:
                rec["proof"], own = serve_input(circuit, config, tx, device, composer,
                                                rng, spans)
            else:
                rec["proof"] = serve(composer, rng, spans, make)
        except Exception as exc:  # a failed request is counted, not fatal
            log(f"request {index} raised {type(exc).__name__}: {exc}")
        rec["latency"] = time.perf_counter() - rec["start"]
        records.append(rec)
        if spans is not None:
            entry = {k: v for k, v in spans.seconds.items() if not k.startswith("round.")}
            entry["rounds"] = {k[len("round."):]: v for k, v in spans.seconds.items()
                               if k.startswith("round.")}
            traced.append(entry)
            if index == traced_ids.stop - 1:
                sync()
                msm.__exit__(None, None, None)
                window.__exit__(None, None, None)
                prof.__exit__(None, None, None)
        if own is not None:   # keep the request's gates as plain data, free the rest
            rec["circuit"] = circuit.reference(config, seed, own)
            own = None
        index += 1
    sync()
    window_s = time.perf_counter() - t_open - drawn_s
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if per_request:
        log(f"drew {len(records) + len(pending)} inputs in {drawn_s:.3f} s, "
            f"left out of the window")
        kept = [r["circuit"] for r in records if "circuit" in r]
        if kept:
            log(f"the check holds {held_bytes(kept[0]) / 2**20:.1f} MiB of plain "
                f"data a request on the host, {len(kept)} requests")

    trace_data = None
    if prof is not None:
        from plonkbench.trace import Trace

        tmp = tempfile.mkdtemp(prefix="plonkbench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            trace_data = Trace.from_chrome(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del prof
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    counts = check_proofs(config, seed, composer, vk, records)
    ref_s = time.perf_counter() - t0
    log(f"reference check {ref_s:.3f} s over {len(records)} proofs, "
        f"{ref_s / max(1, len(records)):.3f} s a proof")
    checks = {k: {"value": v, "limit": 0} for k, v in counts.items()}
    failed = sum(not r["ok"] for r in records)
    correct = bool(records) and all(c["value"] <= c["limit"] for c in checks.values())

    out = {"correct": correct, "attempted": len(records), "failed": failed,
           "window_s": window_s, "drawn_s": drawn_s, "setup_s": setup_s, "peak": peak,
           "latencies": [r["latency"] for r in records], "checks": checks}
    if not trace:
        values = end_to_end_values(out["latencies"], failed, window_s, setup_s, peak)
        out["metrics"] = {k: values[k] for k in end_to_end}
        return out

    run = {"setup": setup, "traced": traced, "trace": trace_data,
           "subgroup": vk.n, "width": verifier.for_config(config).width}
    units = unit_table()
    out["metrics"] = {}
    for m in per_layer:
        v = metric_reader(m)(run)
        if v is not None:
            out["metrics"][m] = {"value": v, "unit": units[m]}
    if trace_data is not None:
        w0, w1 = trace_data.window()
        out["busy_s"] = sum(e - s for s, e in trace_data.busy_intervals()) / 1e6
        out["traced_window_s"] = (w1 - w0) / 1e6
        out["breakdown"] = breakdown(trace_data)
    return out


def held_bytes(circuit) -> int:
    """Host bytes of a circuit's plain data: its lists and the integers in
    them, each object once."""
    seen, total = set(), 0
    for values in (circuit.variables, circuit.real, circuit.public_inputs,
                   *circuit.wires, *circuit.selectors.values()):
        total += sys.getsizeof(values)
        for v in values:
            if id(v) not in seen:
                seen.add(id(v))
                total += sys.getsizeof(v)
    return total


def unit_table(bench_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    with open(bench_path) as f:
        bench = json.load(f)
    return {m["name"]: m["unit"] for kind in ("end_to_end", "per_layer")
            for m in bench[kind]}


def breakdown(trace) -> dict:
    """The ten device operations with the most time in the traced window, and
    the idle time by the benchmark span open on the host, in seconds."""
    from plonkbench.trace import symbol

    w0, w1 = trace.window()
    ops: dict = {}
    for name, _, s, d, _ in trace.ops:
        if w0 <= s < w1:
            key = symbol(name) or name[:96]
            ops[key] = ops.get(key, 0.0) + d / 1e6
    idle: dict = {}
    for s, e in trace.idle_gaps():
        key = trace.open_span(s)
        idle[key] = idle.get(key, 0.0) + (e - s) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [list(x) for x in top], "idle_gaps": [list(x) for x in gaps]}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("none", "stale_blinding", "stale_tx"),
                    default="none",
                    help="serve the control of the comparison (not a benchmark run)")
    args = ap.parse_args(argv)

    data = load_cell(args.workload)
    cell = data[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card()}")
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   control=args.control, cell_data=data)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}")
        return 3
    line = result_line(res, torch.cuda.get_device_name(0), cell["chips"], bool(args.trace))
    print(f"proof_p90_s samples: {len(res['latencies'])}; window {res['window_s']:.3f} s",
          flush=True)
    for k, c in res["checks"].items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
    return 0


def result_line(res: dict, kind: str, chips: int, trace: bool) -> dict:
    """The last line's object; ``checks`` comes last."""
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": res["peak"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "device": device}
    if trace:
        device["busy_s"] = res.get("busy_s", 0.0)
        device["window_s"] = res.get("traced_window_s", 0.0)
        if "breakdown" in res:
            line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
