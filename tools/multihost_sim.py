"""Multi-host (M5) validation via 2 simulated hosts (SURVEY.md §7 M5).

The reference is a single-process CPU script; this framework's
multi-host story (BASELINE.json:11 "multi-host batched stereo stream")
must be executable on one machine.  This tool simulates 2 hosts with 2
OS processes, each owning 4 virtual CPU devices (the CPU is forced, so
no process ever opens an accelerator), joined through
`jax.distributed.initialize` (localhost coordinator; cross-process
collectives ride Gloo, same `Mesh`-shaped program as on real hosts).

Modes:
  parent (default)      orchestrates the runs below and writes the
                        report JSON to --out.
  --worker              one simulated host: initialise distributed
                        (unless --num-processes 1), build the GLOBAL
                        ("data", "model") mesh spanning both hosts, run
                        the batched stereo stream (parallel/runner.py)
                        for each strategy, verify gathered outputs
                        BITWISE against the single-device pipeline, and
                        write a per-process report JSON.

What the artifact certifies:
  * 2-process completion: both workers finish `run_stream` over a mesh
    whose "data" axis spans the host boundary (each host computes its
    own batch shard; `ppermute`/`all_gather`/`all_to_all` inside the
    wtiled/dslab strategies cross processes).
  * per-process shard consistency: every host gathers the full outputs
    and both report identical SHA-256 digests, which also equal the
    single-device pipeline's digest (bit-equality under multi-host
    sharding, BASELINE.json:5).
  * 1-host vs 2-host scaling rows (CPU-simulated timing, so indicative
    of mechanism, not of any accelerator's efficiency).

Usage: python tools/multihost_sim.py [--pairs 8] [--out REPORT.json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------


def _make_pairs(n, h, w, max_d, seed=0):
    import numpy as np

    from deepmatching_stereo_matching_tpu.data import synthetic

    pairs = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        field = synthetic.block_disparity_field(h, w, max_d, rng, block=24)
        left, right, _ = synthetic.make_pair(h, w, field, seed=seed + i)
        pairs.append((left, right))
    return pairs


def _digest(arrays) -> str:
    import numpy as np

    hsh = hashlib.sha256()
    for a in arrays:
        hsh.update(np.ascontiguousarray(a).tobytes())
    return hsh.hexdigest()


def worker(args) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from deepmatching_stereo_matching_tpu import Config, parallel
    from deepmatching_stereo_matching_tpu.models import pipeline
    from deepmatching_stereo_matching_tpu.parallel import runner
    from deepmatching_stereo_matching_tpu.utils.logging import JsonlLogger

    if args.num_processes > 1:
        runner.init_distributed(args.coordinator, args.num_processes,
                                args.process_id)
    assert jax.process_count() == args.num_processes
    n_dev = len(jax.devices())

    h, w, max_d = args.height, args.width, 16
    cfg = Config(max_disparity=max_d, levels=2)
    pairs = _make_pairs(args.pairs, h, w, max_d)
    batch_size = args.pairs // 2

    report = {
        "process_id": args.process_id,
        "process_count": jax.process_count(),
        "global_devices": n_dev,
        "local_devices": len(jax.local_devices()),
        "strategies": {},
    }
    for strategy, mesh in [
        ("tiled", parallel.make_mesh(2, n_dev // 2)),
        ("dslab", parallel.make_mesh(2, n_dev // 2)),
        ("ringd", parallel.make_mesh(2, n_dev // 2)),
        ("wtiled", parallel.make_mesh2d(2, 1, n_dev // 2)),
    ]:
        # Warm-up stream (compiles the sharded step) so the reported
        # Mpx/s is steady-state, as in runner.scaling_sweep.
        runner.run_stream(pairs[:batch_size], cfg, h, w, mesh, strategy,
                          batch_size)
        collected = {}
        rep = runner.run_stream(
            pairs, cfg, h, w, mesh, strategy, batch_size,
            on_result=lambda i, out: collected.update({i: out}),
            logger=JsonlLogger(args.log) if args.log else None)
        # Bitwise parity with the single-device pipeline on the same
        # strategy-padded inputs, on every host.
        got = [collected[i][k] for i in sorted(collected)
               for k in sorted(collected[i])]
        lefts = parallel.pad_batch([p[0] for p in pairs], cfg, h, w,
                                   mesh, strategy)
        rights = parallel.pad_batch([p[1] for p in pairs], cfg, h, w,
                                    mesh, strategy)
        want = []
        for i in range(0, args.pairs, batch_size):
            outs = [pipeline.match_padded(lefts[j], rights[j], cfg, h, w)
                    for j in range(i, i + batch_size)]
            for k in sorted(outs[0]):
                want.append(np.stack([np.asarray(o[k]) for o in outs]))
        for g_arr, w_arr in zip(got, want):
            np.testing.assert_array_equal(g_arr, w_arr)
        report["strategies"][strategy] = {
            "batches_completed": rep.batches_completed,
            "pairs_completed": rep.pairs_completed,
            "retries": rep.retries,
            "mpx_per_s": round(rep.mpx_per_s, 3),
            "output_sha256": _digest(got),
            "single_device_sha256": _digest(want),
            "bitwise_equal": True,
        }
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)


# ---------------------------------------------------------------------------
# Parent
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(n_procs, local_devices, args, tag):
    """Launch n worker processes; returns their report dicts."""
    port = _free_port()
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{local_devices}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    procs, reports = [], []
    try:
        for pid in range(n_procs):
            rpt = os.path.join(args.tmpdir, f"{tag}_p{pid}.json")
            reports.append(rpt)
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   "--process-id", str(pid),
                   "--num-processes", str(n_procs),
                   "--coordinator", f"localhost:{port}",
                   "--pairs", str(args.pairs),
                   "--height", str(args.height),
                   "--width", str(args.width),
                   "--report", rpt]
            log = open(os.path.join(args.tmpdir, f"{tag}_p{pid}.log"), "w")
            procs.append((subprocess.Popen(cmd, env=env, stdout=log,
                                           stderr=subprocess.STDOUT), log))
        deadline = time.time() + args.timeout
        for p, _ in procs:
            p.wait(timeout=max(5.0, deadline - time.time()))
    finally:
        # A hung/failed worker must not leak its siblings (they hold
        # the coordination-service port) or the open log handles.
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for pid, (p, _) in enumerate(procs):
        if p.returncode != 0:
            logf = os.path.join(args.tmpdir, f"{tag}_p{pid}.log")
            with open(logf) as f:
                tail = f.read()[-2000:]
            raise RuntimeError(
                f"{tag} worker {pid} exited {p.returncode}:\n{tail}")
    out = []
    for r in reports:
        with open(r) as f:
            out.append(json.load(f))
    return out


def parent(args) -> None:
    import tempfile

    args.tmpdir = tempfile.mkdtemp(prefix="multihost_sim_")
    t0 = time.time()
    single = _spawn(1, 8, args, "single")[0]
    multi = _spawn(2, 4, args, "multi")

    strategies = {}
    for strat in single["strategies"]:
        s1 = single["strategies"][strat]
        m0, m1 = (m["strategies"][strat] for m in multi)
        consistent = (m0["output_sha256"] == m1["output_sha256"]
                      == s1["output_sha256"])
        eff = round(m0["mpx_per_s"] / s1["mpx_per_s"], 3)
        strategies[strat] = {
            "single_process_mpx_per_s": s1["mpx_per_s"],
            "two_process_mpx_per_s": m0["mpx_per_s"],
            # Same 8 global devices either way; 1.0 = the host boundary
            # (Gloo collectives + 2-process coordination) costs nothing.
            "cross_host_overhead_factor": eff,
            "shards_consistent_across_hosts": consistent,
            "bitwise_equal_to_single_device": bool(
                m0["bitwise_equal"] and m1["bitwise_equal"] and consistent),
        }
        if not consistent:
            raise SystemExit(f"digest mismatch for {strat}")
    out = {
        "ok": True,
        "processes": 2,
        "local_devices_per_process": 4,
        "global_devices": 8,
        "pairs": args.pairs,
        "image": [args.height, args.width],
        "seconds": round(time.time() - t0, 1),
        "strategies": strategies,
        "process_reports": multi,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k != "process_reports"}, indent=1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default="localhost:12345")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--report", default="multihost_report.json")
    ap.add_argument("--log", default=None)
    ap.add_argument("--timeout", type=float, default=480.0)
    ap.add_argument("--out", default="multihost_sim.json")
    args = ap.parse_args()
    if args.worker:
        worker(args)
    else:
        parent(args)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
