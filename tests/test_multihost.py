"""2-process multi-host simulation (SURVEY.md §7 M5, §4.4).

Launches tools/multihost_sim.py, which spawns one single-process run and
two coordinated `jax.distributed` processes (4 virtual CPU devices each,
Gloo collectives standing in for the network between hosts) and asserts every strategy's
stream output is bitwise-identical to the single-device pipeline and
consistent across hosts.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM = os.path.join(REPO, "tools", "multihost_sim.py")


@pytest.mark.slow
def test_two_process_stream_bitwise(tmp_path):
    out = tmp_path / "MULTIHOST_SIM.json"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device counts
    proc = subprocess.run(
        [sys.executable, SIM, "--pairs", "4", "--height", "64",
         "--width", "96", "--out", str(out)],
        capture_output=True, text=True, timeout=480, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["ok"] and report["processes"] == 2
    assert report["global_devices"] == 8
    # Pin ALL four strategies across the process boundary — ringd's
    # psum + ppermute chains are the collectives most fragile under a
    # real process split.
    for strat in ("tiled", "wtiled", "dslab", "ringd"):
        row = report["strategies"][strat]
        assert row["shards_consistent_across_hosts"], strat
        assert row["bitwise_equal_to_single_device"], strat
