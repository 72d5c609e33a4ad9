"""Multi-host batched stereo stream with failure recovery (SURVEY.md §5.3, M5).

The reference is a single-process script with no failure story; its
replacement here is a streaming runner over a device mesh:

  * `init_distributed` brings up the JAX coordination service for
    multi-host slices (no-op single-host); each host then holds the
    process-local shards of every global batch.
  * `run_stream` drives batches of stereo pairs through a sharded
    pipeline (parallel/sharded.py).  The per-pair pipeline is stateless
    and short (SURVEY.md §5.3/§5.4) so recovery needs no checkpoints:
    the stream records the last completed batch index, failed batches
    are retried `max_retries` times, and a restarted job resumes with
    `start_batch` = the recorded index.  Structured JSONL metrics are
    emitted per batch (utils/logging.py).

The tests run the same runner on a virtual CPU mesh
(tests/test_runner.py); the Mesh-shaped interface is identical on one
GPU or several (SURVEY.md §4.4).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import jax
import numpy as np

from ..config import Config
from ..utils.logging import JsonlLogger
from . import sharded


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Initialize multi-host JAX; returns this host's process index.

    Single-host (all args None): no-op, returns 0.  Multi-host: brings
    up the coordination service, which also provides failure detection —
    a lost host fails collectives on the survivors, surfacing as a
    retryable error in `run_stream` (SURVEY.md §5.3).
    """
    if coordinator_address is None:
        return 0
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return jax.process_index()


def _put(arr: np.ndarray, sharding) -> jax.Array:
    """Host numpy -> (possibly multi-host) global device array.

    Single-process: plain device_put.  Multi-process: every host holds
    the SAME full-size numpy array (the stream is replicated host-side),
    and each builds its addressable shards of the global array from its
    slice — `device_put` cannot target non-addressable devices.
    """
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def _tree_to_host(tree):
    """Global device arrays -> full numpy arrays on EVERY host.

    Multi-process arrays are only partially addressable per host; ONE
    explicit all-gather over hosts materialises the full result tree
    everywhere (outputs are small: a few maps of H x W per pair).
    """
    if jax.process_count() == 1:
        return jax.tree.map(np.asarray, tree)
    from jax.experimental import multihost_utils

    return jax.tree.map(np.asarray,
                        multihost_utils.process_allgather(tree, tiled=True))


def pairs_from_paths(left_paths: Sequence[str],
                     right_paths: Sequence[str], cfg: Config,
                     height: int, width: int,
                     mesh: Optional[jax.sharding.Mesh] = None,
                     strategy: str = "tiled",
                     merge_level: Optional[int] = None,
                     num_threads: int = 4):
    """Stream (left, right) pre-padded float32 planes from image files.

    Uses the native C++ prefetch loader (decode + grayscale/normalise/
    pad on worker threads, overlapping the device's previous batch) when
    it is available and every input is PNM or PNG — the Middlebury/
    KITTI dataset formats stream PIL-free; otherwise falls back to the
    Python readers.  Both paths emit bit-identical planes
    (tests/test_native.py) shaped for `strategy`'s padded geometry, so
    the output feeds `run_stream` directly.
    """
    from .. import native
    from . import mesh as mesh_lib

    if mesh is None:
        mesh = mesh_lib.auto_mesh()
    glob = sharded.strategy_geometry(cfg, height, width, mesh, strategy,
                                     merge_level)
    native_fmts = (".pgm", ".ppm", ".pnm", ".png")
    if (native.available()
            and all(p.lower().endswith(native_fmts)
                    for p in list(left_paths) + list(right_paths))):
        with native.PairLoader(list(left_paths), list(right_paths),
                               glob.padded_height, glob.padded_width,
                               num_threads) as loader:
            for _idx, left, right in loader:
                yield sharded.as_padded(left), sharded.as_padded(right)
        return
    from ..io import images
    from ..oracle import reference as oracle

    for lp, rp in zip(left_paths, right_paths):
        left, right = images.load_pair(lp, rp)
        out = []
        for img in (left, right):
            g = oracle.to_grayscale_f32(img)
            plane = np.zeros((glob.padded_height, glob.padded_width),
                             dtype=np.float32)
            plane[: g.shape[0], : g.shape[1]] = g
            out.append(sharded.as_padded(plane))
        yield out[0], out[1]


@dataclasses.dataclass
class StreamReport:
    """Summary of one `run_stream` call."""

    batches_completed: int
    pairs_completed: int
    retries: int
    seconds: float
    mpx_per_s: float


def run_stream(pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
               cfg: Config, height: int, width: int,
               mesh: Optional[jax.sharding.Mesh] = None,
               strategy: str = "tiled",
               batch_size: int = 8,
               start_batch: int = 0,
               max_retries: int = 2,
               merge_level: Optional[int] = None,
               on_result: Optional[Callable[[int, dict], None]] = None,
               logger: Optional[JsonlLogger] = None,
               _match_fn: Optional[Callable] = None) -> StreamReport:
    """Run a stream of stereo pairs through the sharded pipeline.

    Args:
      pairs: iterable of (left, right) arrays, all height x width.
      mesh: device mesh; default `parallel.auto_mesh()`.
      start_batch: skip batches below this index (resume-after-restart).
      max_retries: per-batch retry budget for transient device/host
        failures; exceeded -> the error propagates.
      merge_level: for the "wtiled" strategy, the pyramid level at which
        tiles all_gather-merge (parallel/wtiled.py); changes the input
        padding, so it must flow to both pad_batch and the matcher.
      on_result: callback(batch_index, host_outputs_dict).
      _match_fn: test hook replacing the jitted sharded step
        (fault injection, SURVEY.md §5.3).
    Returns a StreamReport; emits per-batch JSONL metrics via `logger`.
    """
    from . import mesh as mesh_lib

    if mesh is None:
        mesh = mesh_lib.auto_mesh()
    log = logger or JsonlLogger()
    match = _match_fn or (
        lambda lp, rp: sharded.match_batch_sharded(
            lp, rp, cfg, height, width, mesh, strategy, merge_level))
    sharding = sharded.input_sharding(mesh, strategy)
    n_data = mesh.shape["data"]
    if batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} must divide the "
                         f"data axis ({n_data})")

    t_start = time.perf_counter()
    done = retries = pairs_done = 0
    batch: List[Tuple[np.ndarray, np.ndarray]] = []
    index = 0

    def flush(batch, index, real):
        """Run one padded batch; `real` <= len(batch) pairs are genuine.

        Padded tail slots (duplicates of the last pair) are excluded
        from every report: Mpx/s, pairs_completed, and the outputs
        handed to `on_result` all cover the first `real` pairs only.
        """
        nonlocal done, retries, pairs_done
        if index < start_batch:
            return
        lefts = sharded.pad_batch([p[0] for p in batch], cfg, height,
                                  width, mesh, strategy, merge_level)
        rights = sharded.pad_batch([p[1] for p in batch], cfg, height,
                                   width, mesh, strategy, merge_level)
        attempt = 0
        while True:
            try:
                t0 = time.perf_counter()
                lp = _put(lefts, sharding)
                rp = _put(rights, sharding)
                out = match(lp, rp)
                if on_result is not None:
                    # Materialise full results on every host only when a
                    # consumer asked for them (multi-host: an explicit
                    # cross-process gather).
                    out = _tree_to_host(out)
                else:
                    jax.block_until_ready(out)
                dt = time.perf_counter() - t0
                break
            except Exception as e:  # lost host / transient device error
                attempt += 1
                retries += 1
                log.log("batch_retry", batch=index, attempt=attempt,
                        error=repr(e)[:200])
                if attempt > max_retries:
                    log.log("stream_failed", batch=index,
                            completed_batches=done)
                    raise
        done += 1
        pairs_done += real
        log.log("batch_done", batch=index, pairs=real,
                seconds=round(dt, 4),
                mpx_per_s=round(real * height * width * 1e-6 / dt, 3))
        if on_result is not None:
            on_result(index, {k: v[:real] for k, v in out.items()})

    for pair in pairs:
        batch.append(pair)
        if len(batch) == batch_size:
            flush(batch, index, batch_size)
            batch = []
            index += 1
    if batch:
        # Pad the tail batch by repeating the last pair; the padded
        # slots are stripped from the outputs and all accounting.
        tail = len(batch)
        while len(batch) % batch_size:
            batch.append(batch[-1])
        log.log("tail_batch", batch=index, real_pairs=tail)
        flush(batch, index, tail)

    seconds = time.perf_counter() - t_start
    report = StreamReport(
        batches_completed=done,
        pairs_completed=pairs_done,
        retries=retries,
        seconds=seconds,
        mpx_per_s=pairs_done * height * width * 1e-6 / max(seconds, 1e-9),
    )
    log.log("stream_done", **dataclasses.asdict(report))
    return report


def scaling_sweep(cfg: Config, height: int, width: int,
                  mesh_sizes: Sequence[int],
                  batch_size: int = 8, n_batches: int = 4,
                  strategy: str = "tiled",
                  merge_level: Optional[int] = None,
                  seed: int = 0) -> List[dict]:
    """Mpx/s at several mesh widths -> scaling-efficiency table (M5).

    Runs the same synthetic workload on meshes of each size (devices
    permitting) and reports throughput plus efficiency relative to the
    smallest mesh (BASELINE.md scaling target).
    """
    from ..data import synthetic
    from . import mesh as mesh_lib

    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(batch_size * n_batches):
        field = synthetic.block_disparity_field(
            height, width, cfg.max_disparity, rng, block=32)
        left, right, _ = synthetic.make_pair(height, width, field,
                                             seed=seed + i)
        pairs.append((left, right))

    rows = []
    base = None
    for n in mesh_sizes:
        if n > len(jax.devices()):
            continue
        n_data = 2 if (n % 2 == 0 and batch_size % 2 == 0 and n > 1) else 1
        n_model = n // n_data
        if strategy == "wtiled":
            # 2-D tile grid: favour a square-ish (th, tw) split.
            n_th = 1
            for cand in range(int(n_model ** 0.5), 0, -1):
                if n_model % cand == 0:
                    n_th = cand
                    break
            mesh = mesh_lib.make_mesh2d(n_data, n_th, n_model // n_th)
        else:
            mesh = mesh_lib.make_mesh(n_data, n_model)
        # Warm-up compile outside the timed stream.
        run_stream(pairs[:batch_size], cfg, height, width, mesh,
                   strategy, batch_size, merge_level=merge_level)
        rep = run_stream(pairs, cfg, height, width, mesh, strategy,
                         batch_size, merge_level=merge_level)
        row = {"devices": n, "mesh": dict(mesh.shape),
               "mpx_per_s": round(rep.mpx_per_s, 3)}
        if base is None:
            base = (n, rep.mpx_per_s)
        row["scaling_efficiency"] = round(
            (rep.mpx_per_s / base[1]) / (n / base[0]), 3)
        rows.append(row)
    return rows
