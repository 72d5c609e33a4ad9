#!/usr/bin/env python
"""Virtual-device scaling sweep for all four sharded strategies.

Runs every sharded strategy over 1/2/4/8 VIRTUAL CPU devices
(xla_force_host_platform_device_count) plus a weak-scaling DP row at
fixed batch/device, and records Mpx/s + scaling-efficiency columns per
mesh size.  It checks the decomposition, not any accelerator: the CPU
is forced.

Usage: python tools/scaling_sweep.py [--out SCALING.json]

CAVEAT RECORDED IN THE ARTIFACT: virtual CPU devices share one host's
physical cores (this machine has very few) and model NO interconnect.
On a fixed-core host, TOTAL throughput cannot grow with virtual device
count — the meaningful check is that total Mpx/s stays ~FLAT as the
mesh widens (no replicated-compute or collective-volume blowup in the
decomposition), reported as `total_vs_1dev`.  The conventional
per-device `scaling_efficiency` column is also recorded but is ~1/n by
construction here.
"""

import argparse
import json
import os
import sys

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deepmatching_stereo_matching_tpu import Config, parallel  # noqa: E402
from deepmatching_stereo_matching_tpu.data import synthetic  # noqa: E402
from deepmatching_stereo_matching_tpu.parallel import (  # noqa: E402
    mesh as mesh_lib,
    runner,
)

import numpy as np  # noqa: E402

H, W, D = 128, 192, 16
MESH_SIZES = (1, 2, 4, 8)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def dp_weak_scaling(cfg, batch_per_device=4, n_batches=3, seed=5):
    """DP rows at FIXED batch/device (weak scaling): mesh (n, 1)."""
    rows = []
    base = None
    for n in MESH_SIZES:
        if n > len(jax.devices()):
            continue
        mesh = mesh_lib.make_mesh(n, 1)
        batch = batch_per_device * n
        rng = np.random.default_rng(seed)
        pairs = []
        for i in range(batch * n_batches):
            field = synthetic.block_disparity_field(H, W, D, rng,
                                                    block=32)
            left, right, _ = synthetic.make_pair(H, W, field,
                                                 seed=seed + i)
            pairs.append((left, right))
        runner.run_stream(pairs[:batch], cfg, H, W, mesh, "tiled",
                          batch)  # warm-up compile
        rep = runner.run_stream(pairs, cfg, H, W, mesh, "tiled", batch)
        row = {"devices": n, "mesh": dict(mesh.shape),
               "batch_per_device": batch_per_device,
               "mpx_per_s": round(rep.mpx_per_s, 3)}
        if base is None:
            base = (n, rep.mpx_per_s)
        row["scaling_efficiency"] = round(
            (rep.mpx_per_s / base[1]) / (n / base[0]), 3)
        rows.append(row)
        log(f"dp n={n}: {row}")
    return rows


def annotate_total(rows):
    """Add total_vs_1dev: total throughput relative to the 1-device row
    (the flat-is-good metric on an oversubscribed fixed-core host)."""
    if not rows:
        return rows
    base = rows[0]["mpx_per_s"]
    for r in rows:
        r["total_vs_1dev"] = round(r["mpx_per_s"] / base, 3)
    return rows


def main():
    import multiprocessing

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="SCALING.json")
    path = ap.parse_args().out

    cfg = Config(max_disparity=D)
    out = {
        "geometry": {"height": H, "width": W, "max_disparity": D},
        "devices": "virtual CPU (xla_force_host_platform_device_count)",
        "host_physical_cores": multiprocessing.cpu_count(),
        "caveat": (
            "Virtual CPU devices share this host's few physical cores "
            "and model no interconnect: total Mpx/s cannot grow with "
            "virtual device count, so the meaningful column is "
            "total_vs_1dev staying ~flat (no replicated-compute or "
            "collective-volume blowup in the decomposition); the "
            "per-device scaling_efficiency column is ~1/n by "
            "construction here."),
        "strategies": {},
    }
    for strategy, merge_level in (("tiled", None), ("dslab", None),
                                  ("ringd", None), ("wtiled", 1)):
        log(f"=== {strategy} ===")
        rows = parallel.scaling_sweep(
            cfg, H, W, mesh_sizes=MESH_SIZES, batch_size=8, n_batches=3,
            strategy=strategy, merge_level=merge_level)
        out["strategies"][strategy] = annotate_total(rows)
        for r in rows:
            log(f"  {r}")
    log("=== dp (weak scaling, fixed batch/device) ===")
    out["strategies"]["dp_weak"] = annotate_total(dp_weak_scaling(cfg))
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {path}")


if __name__ == "__main__":
    main()
