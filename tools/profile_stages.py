#!/usr/bin/env python
"""Per-stage timing of the jitted pipeline on the GPU.

Each stage of one matching direction (descriptors, cost volume, pyramid,
backtracking, LR check) is jitted on its own over a batch of
Middlebury-class pairs (450x375, D=64) and timed with
`utils/timing.steady_state`: host clock around `jax.block_until_ready`.
The full two-direction step is timed last.  Stage times are of isolated
programs, so XLA fuses across stage boundaries in the full step and the
stages need not add up to it.

Usage:
  python tools/profile_stages.py [--batch 32] [--repeats 5] [--iters 10]
  python tools/profile_stages.py --cpu --batch 1 --height 64 --width 96

Off the GPU it exits nonzero unless `--cpu` asks for the CPU explicitly
(a rehearsal: its times are not device numbers).  Prints one JSON line
with the per-stage medians in ms.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--height", type=int, default=375)
    ap.add_argument("--width", type=int, default=450)
    ap.add_argument("-D", "--max-disparity", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU backend")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu:
        log(f"error: no GPU found (platform {dev.platform!r})")
        sys.exit(1)

    import jax.numpy as jnp

    from deepmatching_stereo_matching_tpu import Config
    from deepmatching_stereo_matching_tpu.data import synthetic
    from deepmatching_stereo_matching_tpu.models import descriptors, pipeline
    from deepmatching_stereo_matching_tpu.ops import costvol as costvol_ops
    from deepmatching_stereo_matching_tpu.oracle import reference as oracle
    from deepmatching_stereo_matching_tpu.utils import timing
    from deepmatching_stereo_matching_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    h, w, max_d, batch = args.height, args.width, args.max_disparity, \
        args.batch
    cfg = Config(max_disparity=max_d)
    geom = cfg.geometry(h, w)
    log(f"device={dev.device_kind} geom={geom} batch={batch}")

    lp, rp = [], []
    for i in range(batch):
        rng = np.random.default_rng(i)
        field = synthetic.block_disparity_field(h, w, max_d, rng, block=32)
        left, right, _ = synthetic.make_pair(h, w, field, seed=i)
        lp.append(oracle.pad_image(oracle.to_grayscale_f32(left), geom))
        rp.append(oracle.pad_image(oracle.to_grayscale_f32(right), geom))
    ls = jnp.asarray(np.stack(lp))
    rs = jnp.asarray(np.stack(rp))

    def measure(name, fn, *a):
        st = timing.steady_state(fn, a, repeats=args.repeats,
                                 iters=args.iters)
        log(f"{name:<12} {timing.fmt(st)}")
        rows[name] = st
        return fn(*a)

    rows = {}

    @jax.jit
    def f_desc(ls, rs):
        d1 = jax.vmap(lambda x: descriptors.left_descriptors(x, cfg))(ls)
        d2 = jax.vmap(
            lambda x: descriptors.right_sliding_descriptors(x, cfg))(rs)
        return d1, d2

    d_src, d_tgt = measure("descriptors", f_desc, ls, rs)

    @jax.jit
    def f_cv(a, b):
        return jax.vmap(lambda s, t_: costvol_ops.cost_volume(
            s, t_, geom.disparities, cfg.patch_size,
            cfg.max_disparity))(a, b)

    cost0 = measure("costvol", f_cv, d_src, d_tgt)

    @jax.jit
    def f_pyr(c):
        return jax.vmap(lambda x: pipeline.build_pyramid(
            x, geom.levels, cfg.lam))(c)

    maps, args_ = measure("pyramid", f_pyr, cost0)

    @jax.jit
    def f_bt(maps, args_):
        return jax.vmap(pipeline.backtrack)(list(maps), list(args_))

    disp, _ = measure("backtrack", f_bt, maps, args_)

    @jax.jit
    def f_lr(a):
        return jax.vmap(lambda x: pipeline.lr_consistency_patch(
            x, x, cfg.tau, geom.disparities, cfg.patch_size))(a)

    measure("lr_check", f_lr, disp)

    @jax.jit
    def f_full(a, b):
        return jax.vmap(lambda l, r: pipeline.match_padded_core(
            l, r, cfg, geom))(a, b)

    measure("full", f_full, ls, rs)

    smi = "not available"
    if not args.cpu:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    full = rows["full"]["median"]
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "nvidia_smi": smi,
        "geometry": [h, w, max_d], "batch": batch,
        "stage_ms_one_direction": {
            k: v["median"] * 1e3 for k, v in rows.items()
            if k != "full"},
        "full_ms_two_directions": full * 1e3,
        "full_spread_ms": [rows["full"]["min"] * 1e3,
                           rows["full"]["max"] * 1e3],
        "mpx_per_s": batch * h * w * 1e-6 / full,
    }))


if __name__ == "__main__":
    main()
