"""Several processes, one sharded MSM: ``torch.distributed`` over gloo.

Port of aztec_tpu/parallel/multihost.py.  N processes join one process
group (gloo, rendezvous through a ``FileStore`` in a temporary directory,
so concurrent runs never meet); each holds K local shards of the global
point set on its own ``Mesh`` (the card unless asked for the CPU), computes
their partial sums (``sharded_msm.shard_partials``), and contributes them
to one ``all_gather`` of the N K width-1 points as host tensors (a few
hundred bytes each way).  Every process folds the gathered points in the
same order (``sharded_msm.combine``); process 0 checks the result against
the single-device MSM of all the points (``msm.pippenger.msm`` as a user
calls it) and against the host golden (sum k_i tau^i) G, and prints
"MULTIHOST OK".

Run: python -m aztec_tpu_torch.parallel.multihost [--device cpu]
(spawns its workers itself).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

N_PROCS = 2
DEVS_PER_PROC = 2
SEED = 3
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _inputs(n: int, device):
    """The first n points of the committed table and seeded scalars, the
    same on every process."""
    import numpy as np
    import torch

    from ..curves.spec import BN254_G1
    from ..numeric.bigint import ints_to_limbs
    from ..srs.reference_string import load_point_table

    X, Y = (torch.as_tensor(p.astype(np.int32), device=device)
            for p in load_point_table(n))
    rng = np.random.default_rng(SEED)
    ks = [int.from_bytes(rng.bytes(32), "little") % BN254_G1.order
          for _ in range(n)]
    S = torch.as_tensor(ints_to_limbs(ks).astype(np.int32), device=device)
    return (X[:, :n], Y[:, :n]), S, ks


def _worker(rank: int, store: str, n: int, device: str, config) -> None:
    import torch
    import torch.distributed as dist

    from ..curves import golden
    from ..curves.io import jacobian_to_host
    from ..curves.spec import BN254_G1
    from ..msm.pippenger import msm
    from ..srs.reference_string import DEV_TAU
    from .mesh import Mesh
    from .sharded_msm import combine, shard_partials

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=N_PROCS, rank=rank)
    try:
        mesh = Mesh.local(DEVS_PER_PROC, device)
        (X, Y), S, ks = _inputs(n, mesh.devices[0])
        per = n // N_PROCS
        sl = slice(rank * per, (rank + 1) * per)
        parts = shard_partials(mesh, (X[:, sl], Y[:, sl]), S[:, sl],
                               BN254_G1, config)
        mine = torch.stack([torch.cat(p, dim=1).cpu() for p in parts])
        gathered = [torch.empty_like(mine) for _ in range(N_PROCS)]
        dist.all_gather(gathered, mine)
        points = [tuple(g[k].split(1, dim=1)) for g in gathered
                  for k in range(DEVS_PER_PROC)]
        out = jacobian_to_host(combine(points, BN254_G1, mesh.devices[0]),
                               BN254_G1)[0]
        if rank == 0:
            single = jacobian_to_host(msm((X, Y), S, BN254_G1), BN254_G1)[0]
            r = BN254_G1.order
            kk = sum(k * pow(DEV_TAU, i, r) for i, k in enumerate(ks)) % r
            expect = golden.GoldenCurve(BN254_G1).mul(
                kk, (BN254_G1.gen_x, BN254_G1.gen_y))
            if out != single or out != expect:
                raise AssertionError(f"multihost MSM {out} != single-device "
                                     f"{single} / golden {expect}")
            print(f"MULTIHOST OK {out[0]:#x} {out[1]:#x}", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(n: int = 1 << 7, device: str = "cuda", config=None,
           timeout_s: int = 1800) -> bool:
    """Spawn the N workers; True iff process 0 printed MULTIHOST OK.
    ``config``: (c, block, bucket_block, glv) of the shards' engine MSMs
    (default the reference's (4, 16, 4, False))."""
    c, block, bucket_block, glv = config or (4, 16, 4, False)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory(prefix="multihost_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-u", "-m", "aztec_tpu_torch.parallel.multihost",
             "--rank", str(rank), "--store", store, "--n", str(n),
             "--device", device, "--config",
             f"{c},{block},{bucket_block},{int(glv)}"],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE if rank == 0 else subprocess.DEVNULL,
            stderr=None, text=True) for rank in range(N_PROCS)]
        try:
            out, _ = procs[0].communicate(timeout=timeout_s)
            for p in procs[1:]:
                p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            return False
    ok = "MULTIHOST OK" in (out or "")
    if out:
        print(out, end="", flush=True)
    return ok and all(p.returncode == 0 for p in procs)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--store")
    ap.add_argument("--n", type=int, default=1 << 7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="4,16,4,0")
    a = ap.parse_args(argv)
    c, block, bucket_block, glv = (int(v) for v in a.config.split(","))
    if a.rank is not None:
        from ..msm.pippenger import MSMConfig

        _worker(a.rank, a.store, a.n, a.device,
                MSMConfig(c=c, block=block, bucket_block=bucket_block,
                          glv=bool(glv)))
        return 0
    ok = launch(a.n, a.device, (c, block, bucket_block, bool(glv)))
    print(f"multihost run: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
