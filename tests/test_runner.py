"""Streaming runner: batching, resume, fault injection, scaling sweep.

SURVEY.md §5.3: the pipeline is stateless per pair, so recovery is
re-running the failed batch; these tests inject transient failures into
the match step and check the retry/resume/bookkeeping behaviour on the
8-device virtual CPU mesh.
"""

import numpy as np
import pytest

from deepmatching_stereo_matching_tpu import Config, parallel
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.utils.logging import JsonlLogger

H, W, D = 64, 96, 16


def make_pairs(n, seed=0):
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        field = synthetic.block_disparity_field(H, W, D, rng, block=16)
        left, right, _ = synthetic.make_pair(H, W, field, seed=seed + i)
        out.append((left, right))
    return out


def test_stream_completes_and_reports(tmp_path):
    cfg = Config(max_disparity=D)
    mesh = parallel.make_mesh(2, 4)
    results = {}
    log_path = str(tmp_path / "metrics.jsonl")
    with JsonlLogger(log_path) as logger:
        report = parallel.run_stream(
            make_pairs(8), cfg, H, W, mesh, batch_size=4,
            on_result=lambda i, out: results.update({i: out}),
            logger=logger)
    assert report.batches_completed == 2
    assert report.pairs_completed == 8
    assert report.retries == 0
    assert sorted(results) == [0, 1]
    assert results[0]["disparity"].shape == (4, H, W)
    import json

    events = [json.loads(l) for l in open(log_path)]
    assert [e["event"] for e in events].count("batch_done") == 2


def test_stream_tail_batch_padding():
    """Padded tail slots are excluded from all accounting."""
    cfg = Config(max_disparity=D)
    mesh = parallel.make_mesh(1, 8)
    results = {}
    report = parallel.run_stream(
        make_pairs(5), cfg, H, W, mesh, batch_size=4,
        on_result=lambda i, out: results.update({i: out}))
    assert report.batches_completed == 2  # 4 + padded tail of 1
    assert report.pairs_completed == 5    # NOT 8: padding doesn't count
    assert results[0]["disparity"].shape == (4, H, W)
    assert results[1]["disparity"].shape == (1, H, W)  # real tail only
    # Throughput denominates in real pixels only.
    assert report.mpx_per_s <= 5 * H * W * 1e-6 / max(report.seconds, 1e-9)


def test_stream_resume_skips_completed():
    cfg = Config(max_disparity=D)
    mesh = parallel.make_mesh(1, 8)
    seen = []
    parallel.run_stream(make_pairs(12), cfg, H, W, mesh, batch_size=4,
                        start_batch=2,
                        on_result=lambda i, out: seen.append(i))
    assert seen == [2]


def test_stream_retries_transient_failure():
    cfg = Config(max_disparity=D)
    mesh = parallel.make_mesh(1, 8)
    calls = {"n": 0}

    def flaky(lp, rp):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected: lost host")
        return parallel.match_batch_sharded(lp, rp, cfg, H, W, mesh,
                                            "tiled")

    report = parallel.run_stream(make_pairs(8), cfg, H, W, mesh,
                                 batch_size=4, _match_fn=flaky)
    assert report.batches_completed == 2
    assert report.retries == 1


def test_stream_exhausts_retries():
    cfg = Config(max_disparity=D)
    mesh = parallel.make_mesh(1, 8)

    def dead(lp, rp):
        raise RuntimeError("injected: permanent failure")

    with pytest.raises(RuntimeError, match="permanent"):
        parallel.run_stream(make_pairs(4), cfg, H, W, mesh, batch_size=4,
                            max_retries=1, _match_fn=dead)


def test_init_distributed_single_host_noop():
    assert parallel.init_distributed() == 0


def test_scaling_sweep_reports_efficiency():
    cfg = Config(max_disparity=D)
    rows = parallel.scaling_sweep(cfg, H, W, mesh_sizes=(1, 4),
                                  batch_size=2, n_batches=2)
    assert [r["devices"] for r in rows] == [1, 4]
    assert rows[0]["scaling_efficiency"] == 1.0
    assert rows[1]["mpx_per_s"] > 0


def test_scaling_sweep_wtiled():
    cfg = Config(max_disparity=D)
    rows = parallel.scaling_sweep(cfg, H, W, mesh_sizes=(4,),
                                  batch_size=2, n_batches=1,
                                  strategy="wtiled", merge_level=1)
    assert rows and rows[0]["mesh"]["th"] * rows[0]["mesh"]["tw"] == 2
    assert rows[0]["mpx_per_s"] > 0
