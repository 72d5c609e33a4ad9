#!/usr/bin/env python
"""Benchmark: full-pipeline Mpx/s per GPU vs the CPU oracle.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": "Mpx/s", "vs_baseline": ...,
   "device": {...}}

Config: Middlebury-class geometry (450x375, D=64; BASELINE.md config 2)
on synthetic pairs generated from seeds, full pipeline including both
LR-consistency directions, batch 32.  The baseline denominator is the
NumPy oracle's Mpx/s on a host CPU — the stand-in for the pure-NumPy
reference (SURVEY.md §4.1/§6) — measured once and cached in
ORACLE_BASELINE.json.

Besides throughput, every run gates QUALITY on the device: the compiled
pipeline must match the NumPy oracle BITWISE on disparity decisions for
PARITY_PAIRS bench pairs, the sharded strategies on a 1-device mesh
must match the unsharded pipeline bitwise, and the adversarial scenes
must stay above their quality floors.  Any violation exits nonzero.
Off the GPU it exits nonzero before measuring anything.

All diagnostics go to stderr; stdout carries exactly the one JSON line.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

H, W, MAX_D = 375, 450, 64
BATCH = 32
# Timing: REPEATS samples of ITERS back-to-back steps each
# (utils/timing.py).
REPEATS, ITERS = 5, 10
ORACLE_FILE = os.path.join(REPO, "ORACLE_BASELINE.json")
# Device parity gate: pairs checked bitwise against the NumPy oracle.
PARITY_PAIRS = 4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_config():
    from deepmatching_stereo_matching_tpu import Config

    return Config(max_disparity=MAX_D)


def make_pairs(n):
    from deepmatching_stereo_matching_tpu.data import synthetic

    pairs = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        field = synthetic.block_disparity_field(H, W, MAX_D, rng, block=32)
        left, right, gt = synthetic.make_pair(H, W, field, seed=100 + i)
        pairs.append((left, right, gt))
    return pairs


def oracle_mpxs(pairs):
    """CPU-reference Mpx/s (cached across rounds; same geometry)."""
    key = {"height": H, "width": W, "max_disparity": MAX_D,
           "lr_check": True, "descriptor": "patch"}
    if os.path.exists(ORACLE_FILE):
        with open(ORACLE_FILE) as f:
            data = json.load(f)
        if data.get("config") == key:
            log(f"oracle baseline (cached): {data['mpx_per_s']:.4f} Mpx/s")
            return data["mpx_per_s"]

    from deepmatching_stereo_matching_tpu.oracle import reference as oracle

    cfg = bench_config()
    left, right, _ = pairs[0]
    t0 = time.perf_counter()
    oracle.match_stereo(left, right, cfg)
    dt = time.perf_counter() - t0
    v = H * W * 1e-6 / dt
    with open(ORACLE_FILE, "w") as f:
        json.dump({"config": key, "mpx_per_s": v, "seconds_per_pair": dt,
                   "note": "NumPy oracle (stand-in for the pure-NumPy "
                           "reference, SURVEY.md §4.1) on this host's CPU"},
                  f, indent=1)
    log(f"oracle baseline (measured): {v:.4f} Mpx/s ({dt:.2f} s/pair)")
    return v


def batch_step(cfg, geom):
    """Jitted vmapped full-pipeline step over a batch of padded pairs."""
    import jax

    from deepmatching_stereo_matching_tpu.models import pipeline

    return jax.jit(lambda ls, rs: jax.vmap(
        lambda a, b: pipeline.match_padded_core(a, b, cfg, geom))(ls, rs))


def padded_batch(pairs, geom):
    from deepmatching_stereo_matching_tpu.oracle import reference as oracle

    lp = np.stack([oracle.pad_image(oracle.to_grayscale_f32(l), geom)
                   for l, _, _ in pairs])
    rp = np.stack([oracle.pad_image(oracle.to_grayscale_f32(r), geom)
                   for _, r, _ in pairs])
    return lp, rp


def device_mpxs(pairs):
    import jax

    from deepmatching_stereo_matching_tpu.utils import timing

    cfg = bench_config()
    geom = cfg.geometry(H, W)
    log(f"geom: {geom}")
    step = batch_step(cfg, geom)
    lp, rp = padded_batch(pairs, geom)
    ls, rs = jax.device_put(lp), jax.device_put(rp)
    t0 = time.perf_counter()
    out = jax.block_until_ready(step(ls, rs))
    log(f"compile+first run: {time.perf_counter() - t0:.1f} s")

    stats = timing.steady_state(step, (ls, rs), repeats=REPEATS,
                                iters=ITERS)
    t = stats["median"]
    v = BATCH * H * W * 1e-6 / t
    log(f"device step: {timing.fmt(stats)} steady-state "
        f"for {BATCH} pairs")

    # Quality cross-check on the bench scene (kept-pixel bad rate).
    from deepmatching_stereo_matching_tpu.utils import metrics

    disp = np.asarray(out["disparity"])[:, :H, :W]
    rates = [metrics.bad_pixel_rate(disp[i], pairs[i][2],
                                    count_invalid=False)
             for i in range(BATCH)]
    log(f"kept-pixel bad rates: {[f'{r:.4f}' for r in rates]}")
    return v


def parity_gate(pairs):
    """Compiled device outputs vs the NumPy oracle (exit 1 on failure).

    Disparity decisions (`disparity_raw`, `valid`, `disparity`,
    `disparity_right`) must be BITWISE equal; `score` within 1e-5.
    """
    import jax.numpy as jnp

    from deepmatching_stereo_matching_tpu.models import pipeline
    from deepmatching_stereo_matching_tpu.oracle import reference as oracle
    from deepmatching_stereo_matching_tpu.utils import metrics

    cfg = bench_config()
    sub = pairs[:PARITY_PAIRS]
    t0 = time.perf_counter()
    want = [oracle.match_stereo(l, r, cfg) for l, r, _ in sub]
    log(f"parity gate: oracle on {len(sub)} pairs took "
        f"{time.perf_counter() - t0:.1f} s")

    failures = []
    geom = cfg.geometry(H, W)
    for i, ((left, right, gt), w_) in enumerate(zip(sub, want)):
        got = {k: np.asarray(v) for k, v in pipeline.match_padded(
            jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(left),
                                         geom)),
            jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(right),
                                         geom)),
            cfg, H, W).items()}
        raw_neq = np.mean(got["disparity_raw"] != w_.disparity_raw)
        val_neq = np.mean(got["valid"] != w_.valid)
        bad_dev = metrics.bad_pixel_rate(got["disparity"], gt,
                                         count_invalid=False)
        bad_ora = metrics.bad_pixel_rate(w_.disparity, gt,
                                         count_invalid=False)
        log(f"parity pair {i}: raw_neq={raw_neq:.2e} "
            f"valid_neq={val_neq:.2e} bad_device={bad_dev:.4f} "
            f"bad_oracle={bad_ora:.4f}")
        # Disparity DECISIONS are the bitwise contract; scores may
        # differ in the last ulp (XLA fuses the descriptor
        # normalisation differently than NumPy rounds it).
        ok = (raw_neq == 0.0 and val_neq == 0.0
              and np.array_equal(got["disparity"], w_.disparity,
                                 equal_nan=True)
              and np.array_equal(got["disparity_right"],
                                 w_.disparity_right)
              and np.allclose(got["score"], w_.score, rtol=1e-5))
        if not ok:
            failures.append(f"pair {i}: not bitwise (raw_neq={raw_neq}, "
                            f"valid_neq={val_neq})")
    if failures:
        for f_ in failures:
            log("PARITY FAILURE:", f_)
        sys.exit(1)
    log("parity gate: PASS (bitwise)")


def sharded_smoke():
    """One step of every sharded strategy on a 1-device mesh.

    Proves each shard_map program compiles and runs on the device, and
    is bitwise equal to the unsharded pipeline; then times each at the
    bench geometry so shard_map overhead has a number.
    """
    import jax
    import jax.numpy as jnp

    from deepmatching_stereo_matching_tpu import Config, parallel
    from deepmatching_stereo_matching_tpu.models import pipeline
    from deepmatching_stereo_matching_tpu.parallel import sharded
    from deepmatching_stereo_matching_tpu.data import synthetic
    from deepmatching_stereo_matching_tpu.oracle import reference as oracle
    from deepmatching_stereo_matching_tpu.utils import timing

    h, w, max_d = 96, 128, 16
    cfg = Config(max_disparity=max_d, levels=2)
    rng = np.random.default_rng(3)
    field = synthetic.block_disparity_field(h, w, max_d, rng, block=24)
    left, right, _ = synthetic.make_pair(h, w, field, seed=3)
    cases = [("tiled", parallel.make_mesh(1, 1), None),
             ("wtiled", parallel.make_mesh2d(1, 1, 1), 1),
             ("dslab", parallel.make_mesh(1, 1), None),
             ("ringd", parallel.make_mesh(1, 1), None)]
    ref = pipeline.match_padded(
        jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(left),
                                     cfg.geometry(h, w))),
        jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(right),
                                     cfg.geometry(h, w))),
        cfg, h, w)
    for strategy, mesh, merge_level in cases:
        lp = sharded.pad_batch([left], cfg, h, w, mesh, strategy,
                               merge_level)
        rp = sharded.pad_batch([right], cfg, h, w, mesh, strategy,
                               merge_level)
        out = sharded.match_batch_sharded(
            jnp.asarray(lp), jnp.asarray(rp), cfg, h, w, mesh, strategy,
            merge_level)
        for k in ref:
            if not np.array_equal(np.asarray(out[k][0]), np.asarray(ref[k]),
                                  equal_nan=True):
                log(f"SHARDED SMOKE FAILURE: {strategy}[{k}] != unsharded")
                sys.exit(1)
        log(f"sharded smoke [{strategy}]: 1-device mesh on "
            f"{jax.devices()[0].device_kind}: bitwise OK")

    bcfg = bench_config()
    nb = 8
    rng = np.random.default_rng(11)
    field = synthetic.block_disparity_field(H, W, MAX_D, rng, block=32)
    bl, br, _ = synthetic.make_pair(H, W, field, seed=11)
    for strategy, mesh, merge_level in cases:
        lp = jnp.asarray(sharded.pad_batch([bl] * nb, bcfg, H, W, mesh,
                                           strategy, merge_level))
        rp = jnp.asarray(sharded.pad_batch([br] * nb, bcfg, H, W, mesh,
                                           strategy, merge_level))

        def stepf(a, b, _s=strategy, _m=mesh, _ml=merge_level):
            return sharded.match_batch_sharded(a, b, bcfg, H, W, _m, _s,
                                               _ml)

        st = timing.steady_state(stepf, (lp, rp), repeats=REPEATS,
                                 iters=ITERS)
        v = nb * H * W * 1e-6 / st["median"]
        log(f"sharded perf [{strategy}] 1-device mesh, batch {nb}: "
            f"{timing.fmt(st)}/step = {v:.1f} Mpx/s")


def variant_mpxs(pairs, name, **overrides):
    """Throughput + kept-pixel quality row of a Config variant."""
    import dataclasses
    import jax

    from deepmatching_stereo_matching_tpu.utils import metrics, timing

    cfg = dataclasses.replace(bench_config(), **overrides)
    geom = cfg.geometry(H, W)
    step = batch_step(cfg, geom)
    lp, rp = padded_batch(pairs, geom)
    ls, rs = jax.device_put(lp), jax.device_put(rp)
    out = step(ls, rs)
    stats = timing.steady_state(step, (ls, rs), repeats=REPEATS,
                                iters=ITERS)
    v = BATCH * H * W * 1e-6 / stats["median"]
    disp = np.asarray(out["disparity"])[:, :H, :W]
    rates = [metrics.bad_pixel_rate(disp[i], pairs[i][2],
                                    count_invalid=False)
             for i in range(BATCH)]
    log(f"{name}: {timing.fmt(stats)}/step = {v:.1f} Mpx/s, mean "
        f"kept-pixel bad rate {float(np.mean(rates)):.4f}")
    return v


def adversarial_row():
    """Quality on hostile scenes (occlusion/textureless/photometric
    asymmetry): device outputs vs the oracle, plus the kept-pixel bad
    rate and the LR check's occlusion rejection rate, on
    data/synthetic.py:adversarial_pair scenes."""
    import jax.numpy as jnp

    from deepmatching_stereo_matching_tpu.data import synthetic
    from deepmatching_stereo_matching_tpu.models import pipeline
    from deepmatching_stereo_matching_tpu.oracle import reference as oracle

    cfg = bench_config()
    h, w = 240, 360
    occ_tot = rej = kept = bad = 0
    fails = []
    for seed in range(2):
        left, right, gt, occ = synthetic.adversarial_pair(
            h, w, MAX_D, seed=seed)
        geom = cfg.geometry(h, w)
        lp = jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(left),
                                          geom))
        rp = jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(right),
                                          geom))
        got = {k: np.asarray(v) for k, v in pipeline.match_padded(
            lp, rp, cfg, h, w).items()}
        want = oracle.match_stereo(left, right, cfg)
        # Textureless regions are ALL exact ties by construction, so
        # device-vs-NumPy ULP differences in equal-valued correlations
        # can legitimately flip winners there — decisions are gated at
        # a small rate, not bitwise (the bitwise contract is gated on
        # non-degenerate scenes in parity_gate above).
        raw_neq = float(np.mean(got["disparity_raw"]
                                != want.disparity_raw))
        val_neq = float(np.mean(got["valid"] != want.valid))
        log(f"adversarial seed {seed}: raw_neq={raw_neq:.2e} "
            f"val_neq={val_neq:.2e}")
        if raw_neq > 0.01 or val_neq > 0.01:
            fails.append(f"adversarial seed {seed}: decision "
                         f"disagreement {raw_neq:.4f}/{val_neq:.4f}")
        valid = got["valid"]
        occ_tot += occ.sum()
        rej += (~valid[occ]).sum()
        keep = valid & ~occ & (gt >= 0)
        kept += keep.sum()
        bad += (np.abs(got["disparity"][keep] - gt[keep]) > 1).sum()
    log(f"adversarial scenes: occ_rejection={rej / max(occ_tot, 1):.3f} "
        f"kept-nonocc-bad={bad / max(kept, 1):.4f} "
        f"(oracle decisions {'OK' if not fails else 'FAIL'})")
    # Floors sit just below the values the oracle reaches on these
    # scenes, so a real quality regression fails the bench.
    if fails or rej / max(occ_tot, 1) < 0.6 or bad / max(kept, 1) > 0.15:
        for f_ in fails:
            log("ADVERSARIAL FAILURE:", f_)
        log("ADVERSARIAL FAILURE: quality below floor")
        sys.exit(1)


def native_io_row(pairs):
    """Host input-path throughput: native prefetch loader vs Python.

    Measured on RGB PPM pairs at the bench resolution (the Middlebury-
    realistic decode: Python pays numpy temporaries for the grayscale
    matmul; the C++ loader does decode+gray+normalise+pad in one pass
    on worker threads).  Also measures the OVERLAP case — a consumer
    that "computes" ~5 ms per pair, like the device stream — where
    prefetch should hide the input path entirely.  Host-only; no
    device involvement.  (For pre-grayscale u8 PGMs numpy's vectorised
    reader is faster serially; the loader's win there is overlap only.)
    """
    import tempfile

    from deepmatching_stereo_matching_tpu import native
    from deepmatching_stereo_matching_tpu.io import images
    from deepmatching_stereo_matching_tpu.oracle import reference as oracle

    if not native.available():
        log(f"native io: unavailable ({native.build_error()})")
        return
    cfg = bench_config()
    geom = cfg.geometry(H, W)
    tmp = tempfile.mkdtemp(prefix="bench_native_io_")
    rng = np.random.default_rng(0)
    lefts, rights = [], []
    for i in range(len(pairs)):
        for side, acc in (("l", lefts), ("r", rights)):
            img = rng.integers(0, 256, (H, W, 3), dtype="uint8")
            p = os.path.join(tmp, f"{i}_{side}.ppm")
            native.write_pnm(p, img)
            acc.append(p)

    def py_load(lp, rp):
        return tuple(
            oracle.pad_image(oracle.to_grayscale_f32(images._load_pnm(p)),
                             geom) for p in (lp, rp))

    # Serial decode throughput.
    t0 = time.perf_counter()
    for lp, rp in zip(lefts, rights):
        py_load(lp, rp)
    t_py = time.perf_counter() - t0
    t0 = time.perf_counter()
    with native.PairLoader(lefts, rights, geom.padded_height,
                           geom.padded_width, num_threads=4) as ld:
        n = sum(1 for _ in ld)
    t_nat = time.perf_counter() - t0
    assert n == len(lefts)
    log(f"native io: decode+pad {n} RGB pairs: python {t_py*1e3:.1f} ms, "
        f"native 4-thread prefetch {t_nat*1e3:.1f} ms "
        f"({t_py / max(t_nat, 1e-9):.1f}x)")

    # Overlap: consumer busy ~5 ms/pair (device-step stand-in).
    def busy(seconds):
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            pass

    t0 = time.perf_counter()
    for lp, rp in zip(lefts, rights):
        py_load(lp, rp)
        busy(0.005)
    t_py_ov = time.perf_counter() - t0
    t0 = time.perf_counter()
    with native.PairLoader(lefts, rights, geom.padded_height,
                           geom.padded_width, num_threads=4) as ld:
        for _ in ld:
            busy(0.005)
    t_nat_ov = time.perf_counter() - t0
    compute = 0.005 * n
    log(f"native io overlap (5 ms/pair consumer): python adds "
        f"{(t_py_ov - compute)*1e3:.1f} ms over compute, native adds "
        f"{(t_nat_ov - compute)*1e3:.1f} ms "
        f"({(t_py_ov - compute) / max(t_nat_ov - compute, 1e-9):.1f}x "
        f"less input latency)")


def main():
    import jax

    from deepmatching_stereo_matching_tpu.utils.compile_cache import (
        enable_compile_cache)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"error: bench.py measures the GPU; found platform "
            f"{dev.platform!r}")
        sys.exit(1)
    enable_compile_cache()
    pairs = make_pairs(BATCH)
    base = oracle_mpxs(pairs)
    v = device_mpxs(pairs)
    parity_gate(pairs)
    sharded_smoke()
    variant_mpxs(pairs, "bf16", dtype="bfloat16")
    variant_mpxs(pairs, "grad_hist", descriptor="grad_hist")
    adversarial_row()
    native_io_row(pairs)
    print(json.dumps({
        "metric": "full_pipeline_throughput_per_gpu",
        "value": v,
        "unit": "Mpx/s",
        "vs_baseline": v / base,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)


if __name__ == "__main__":
    main()
