"""tools/bench_multichip.py must run a 2-device shape end to end.

The runnable multi-device throughput tier.  Subprocess
(the tool forces its own virtual device count before importing jax);
numbers are CPU-virtual — the assertions are about plumbing and the
accounting contract, not speed.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "bench_multichip.py")


def test_two_device_route_shape():
    out = subprocess.run(
        [sys.executable, TOOL, "--virtual", "2", "--meshes", "1x1,1x2",
         "--steps", "2", "--warmup", "1", "--rows", "512", "--b_dev", "16",
         "--distinct", "2"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": ""},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    rep = json.loads(last)
    assert rep["virtual"] is True
    meshes = {r["mesh"]: r for r in rep["meshes"]}
    assert set(meshes) == {"1x1", "1x2"}
    one, two = meshes["1x1"], meshes["1x2"]
    assert one["mode"] == "replicate" and one["eff_vs_first"] == 1.0
    assert two["mode"] == "route" and two["n_dev"] == 2
    assert two["global_batch"] == 32 and one["global_batch"] == 16
    # the 1x2 route mesh has a2a wire legs: the probe must measure them
    assert two["coll_probe_ms"] > 0.0
    assert 0.0 < two["coll_share"] < 1.0
    # every row carries the analytic-model companion column
    assert all(r["model_ms"] > 0 for r in rep["meshes"])
    assert all("eff_vs_first" in r for r in rep["meshes"])
