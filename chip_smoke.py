#!/usr/bin/env python
"""Smoke test: the stereo pipeline on one NVIDIA GPU, end to end.

Drives the system through the entry points a user calls and checks what
comes out against the NumPy oracle (oracle/reference.py):

  1. device      require the `gpu` platform; print the card's name and
                 power limit, the JAX version, the compile cache and the
                 native host-IO status;
  2. api         `api.match_stereo` on 4 Middlebury-class pairs
                 (450x375, D=64, LR check), one grad_hist pair, one
                 KITTI-class pair (1242x375, D=128): disparity_raw,
                 valid, disparity and disparity_right BITWISE equal to
                 the oracle, score within rtol 1e-5; the two adversarial
                 scenes within 1% decision disagreement;
  3. cli         the CLI's `--demo -o DIR` (run in this process, so one
                 process holds the card) writes the PFM, the 16-bit PNG
                 and the metrics JSON;
  4. stream      `parallel.run_stream` on a 1-device mesh, strategy
                 "tiled", 3 batches of 8 Middlebury-class pairs, bitwise
                 equal to the unsharded pipeline;
  5. throughput  the vmapped batch-32 step at 450x375, D=64, timed with
                 utils/timing.steady_state.

`--four` runs only the four-card path: `__graft_entry__.dryrun_multichip(4)`
(every sharded strategy bitwise against the single-device pipeline) and
`run_stream` over a ("data", "model") = (4, 1) mesh at the Middlebury
geometry against the single-device pipeline.

Any failed phase exits 1.  On success the last stdout line is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage: python chip_smoke.py [--four]
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import bench  # noqa: E402
from deepmatching_stereo_matching_tpu import Config, api, native  # noqa: E402
from deepmatching_stereo_matching_tpu.data import synthetic  # noqa: E402
from deepmatching_stereo_matching_tpu.oracle import reference as oracle  # noqa: E402,E501

H, W, MAX_D = bench.H, bench.W, bench.MAX_D


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def say(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def nvidia_smi():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi exited {proc.returncode}: {proc.stderr}")
    return proc.stdout.strip().splitlines()


def phase_device(n_devices):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX found platform {devs[0].platform!r}")
    if len(devs) < n_devices:
        fail(f"need {n_devices} GPUs, JAX found {len(devs)}")
    from deepmatching_stereo_matching_tpu.utils.compile_cache import (
        enable_compile_cache)

    cache = enable_compile_cache()
    smi = nvidia_smi()
    for line in smi:
        say(line)
    say(f"phase 1 device: ok — {len(devs)} x {devs[0].device_kind}, "
        f"jax {jax.__version__}, compile cache {cache}, native io "
        f"available={native.available()} error={native.build_error()}")
    return smi[0]


def check_vs_oracle(name, got, want, bitwise=True):
    """Hold one device result to the oracle; fail the phase if not."""
    raw_neq = float(np.mean(got.disparity_raw != want.disparity_raw))
    val_neq = float(np.mean(got.valid != want.valid))
    if bitwise:
        ok = (np.array_equal(got.disparity_raw, want.disparity_raw)
              and np.array_equal(got.valid, want.valid)
              and np.array_equal(got.disparity, want.disparity,
                                 equal_nan=True)
              and np.array_equal(got.disparity_right, want.disparity_right)
              and np.allclose(got.score, want.score, rtol=1e-5))
    else:
        ok = raw_neq <= 0.01 and val_neq <= 0.01
    err = float(np.max(np.abs(got.score - want.score)))
    log(f"{name}: raw_neq={raw_neq:.3e} valid_neq={val_neq:.3e} "
        f"max|score diff|={err:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} differs from the oracle (raw_neq={raw_neq}, "
             f"valid_neq={val_neq}, bitwise={bitwise})")
    return raw_neq


def phase_api():
    t0 = time.perf_counter()
    cfg = Config(max_disparity=MAX_D)
    pairs = bench.make_pairs(4)
    for i, (left, right, _) in enumerate(pairs):
        check_vs_oracle(f"middlebury pair {i}",
                        api.match_stereo(left, right, cfg),
                        oracle.match_stereo(left, right, cfg))
    left, right, _ = pairs[0]
    gcfg = Config(max_disparity=MAX_D, descriptor="grad_hist")
    check_vs_oracle("grad_hist pair", api.match_stereo(left, right, gcfg),
                    oracle.match_stereo(left, right, gcfg))
    kh, kw, kd = 375, 1242, 128
    field = synthetic.block_disparity_field(
        kh, kw, kd, np.random.default_rng(200), block=32)
    left, right, _ = synthetic.make_pair(kh, kw, field, seed=200)
    kcfg = Config(max_disparity=kd)
    check_vs_oracle("kitti pair", api.match_stereo(left, right, kcfg),
                    oracle.match_stereo(left, right, kcfg))
    flips = []
    for seed in range(2):
        left, right, _, _ = synthetic.adversarial_pair(240, 360, MAX_D,
                                                       seed=seed)
        flips.append(check_vs_oracle(
            f"adversarial scene {seed}", api.match_stereo(left, right, cfg),
            oracle.match_stereo(left, right, cfg), bitwise=False))
    say(f"phase 2 api: ok — 4 Middlebury + grad_hist + KITTI pairs bitwise "
        f"vs oracle, adversarial decision flips {flips} "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_cli():
    from deepmatching_stereo_matching_tpu import cli
    from deepmatching_stereo_matching_tpu.io import writers

    with tempfile.TemporaryDirectory() as out:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--demo", "-o", out])
        if rc != 0:
            fail(f"cli exited {rc}")
        meta = json.loads(buf.getvalue().strip().splitlines()[-1])
        for name in ("disparity.pfm", "disparity_16bit.png",
                     "metrics.json"):
            if not os.path.exists(os.path.join(out, name)):
                fail(f"cli did not write {name}")
        pfm = writers.read_pfm(os.path.join(out, "disparity.pfm"))
        if pfm.shape != tuple(meta["shape"]):
            fail(f"cli PFM shape {pfm.shape} != {meta['shape']}")
    say(f"phase 3 cli: ok — wrote PFM, 16-bit PNG, metrics JSON; "
        f"coverage {meta['coverage']}, bad-pixel (kept) "
        f"{meta['bad_pixel_rate_kept']}")


def stream_vs_single(n_data, batches, seed):
    """run_stream over an (n_data, 1) mesh vs the unsharded pipeline."""
    import jax.numpy as jnp

    from deepmatching_stereo_matching_tpu import parallel
    from deepmatching_stereo_matching_tpu.models import pipeline

    cfg = Config(max_disparity=MAX_D)
    geom = cfg.geometry(H, W)
    batch = 8
    pairs = []
    for i in range(batches * batch):
        field = synthetic.block_disparity_field(
            H, W, MAX_D, np.random.default_rng(seed + i), block=32)
        left, right, _ = synthetic.make_pair(H, W, field, seed=seed + i)
        pairs.append((left, right))
    got = {}
    rep = parallel.run_stream(
        pairs, cfg, H, W, parallel.make_mesh(n_data, 1), "tiled", batch,
        on_result=lambda i, out: got.update({i: out}))
    if rep.pairs_completed != len(pairs):
        fail(f"stream completed {rep.pairs_completed}/{len(pairs)} pairs")
    for j, (left, right) in enumerate(pairs):
        want = pipeline.match_padded(
            jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(left),
                                         geom)),
            jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(right),
                                         geom)),
            cfg, H, W)
        for k, v in want.items():
            if not np.array_equal(got[j // batch][k][j % batch],
                                  np.asarray(v), equal_nan=True):
                fail(f"stream pair {j} {k} != unsharded pipeline")
    return rep


def phase_stream():
    rep = stream_vs_single(1, 3, seed=300)
    say(f"phase 4 stream: ok — {rep.batches_completed} batches of 8 on a "
        f"1-device mesh bitwise vs unsharded, {rep.retries} retries")


def phase_throughput(smi):
    import jax

    from deepmatching_stereo_matching_tpu.utils import timing

    cfg = Config(max_disparity=MAX_D)
    geom = cfg.geometry(H, W)
    pairs = bench.make_pairs(bench.BATCH)
    lp, rp = bench.padded_batch(pairs, geom)
    ls, rs = jax.device_put(lp), jax.device_put(rp)
    step = bench.batch_step(cfg, geom)
    t0 = time.perf_counter()
    jax.block_until_ready(step(ls, rs))
    compile_s = time.perf_counter() - t0
    st = timing.steady_state(step, (ls, rs), repeats=7, iters=10)
    mpxs = bench.BATCH * H * W * 1e-6 / st["median"]
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", "not reported")
    say(f"phase 5 throughput: ok — batch {bench.BATCH} at {W}x{H} D={MAX_D}"
        f": median {st['median'] * 1e3} ms/step (min {st['min'] * 1e3}, "
        f"max {st['max'] * 1e3}, {len(st['samples'])} samples of "
        f"{st['iters']} steps), {mpxs} Mpx/s; first call {compile_s:.1f} s;"
        f" peak device memory {peak} B; card: {smi}")


def phase_four():
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    say("four-card dryrun_multichip(4): ok — tiled, dslab, ringd, wtiled "
        "bitwise vs single device")
    rep = stream_vs_single(4, 2, seed=400)
    say(f"four-card stream: ok — {rep.batches_completed} batches of 8 over "
        f"a (4, 1) mesh bitwise vs single device, "
        f"{rep.mpx_per_s} Mpx/s incl. compilation and host work "
        f"({time.perf_counter() - t0:.1f} s)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path")
    args = ap.parse_args()
    n = 4 if args.four else 1
    smi = phase_device(n)
    if args.four:
        phase_four()
    else:
        phase_api()
        phase_cli()
        phase_stream()
        phase_throughput(smi)

    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
