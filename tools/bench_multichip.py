"""Runnable multi-device throughput harness for the sharded FTRL step.

The third tier of the scaling story:

  1. analytic   — tools/scaling_model.py (bytes-at-peak floor model)
  2. structural — tests/test_sharded.py HLO collective pins
  3. RUNNABLE   — this script: trains N real steps per mesh shape and
                  measures per-device throughput, weak-scaling efficiency
                  vs the first mesh, and a collective-wire probe.

On several GPUs this is the one command that produces the measured
scaling table; without them it smoke-runs on a virtual CPU mesh
(--virtual 8), where the NUMBERS are meaningless but the shapes,
shardings, collectives and accounting are the real ones.

Per mesh DxM (data x model):
  * builds the flagship FFM config with per-device batch --b_dev held
    constant (weak scaling over devices) and --rows total table rows
    (sharded over the model axis),
  * times --steps train steps through ShardedStep.train_step (donated
    state, batches pre-placed on device, cycling --distinct prepared
    batches so routing sees fresh ids each step),
  * times a collective-only probe: the route path's three all_to_all wire
    legs ([M,K] ids there, [M,K,E] rows back, [M,K,2E] payloads there;
    parallel/sharded.py::_route/_routed_rows/_table_update_routed) plus
    the D>1 dense-accumulator psum over "data" — the measured analogue of
    scaling_model.py's a2a/psum_acc terms,
  * prints measured vs the analytic floor side by side.

Usage:
  python tools/bench_multichip.py --virtual 8                 # CPU smoke
  python tools/bench_multichip.py --meshes 1x1,1x2,1x4 \
      --b_dev 4096 --rows 4000000 --steps 50                  # GPUs

Reference parity note: the reference is strictly single-process
(/root/reference/src/main.cpp) — this harness measures capability the
reference does not have.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--meshes", default="1x1,1x2,1x4,1x8,2x4",
                   help="comma list of DxM (data x model) mesh shapes")
    p.add_argument("--b_dev", type=int, default=0,
                   help="per-device batch rows (weak scaling); default "
                        "4096 on GPU, 64 on CPU")
    p.add_argument("--rows", type=int, default=0,
                   help="total table rows (n_feats); default 1000000 on "
                        "GPU, 4096 on CPU")
    p.add_argument("--fields", type=int, default=8)
    p.add_argument("--factors", type=int, default=4)
    p.add_argument("--max_nnz", type=int, default=8)
    p.add_argument("--model", default="FFM", choices=["LR", "FM", "FFM"])
    p.add_argument("--lookup_mode", default="auto",
                   choices=["auto", "replicate", "route"])
    p.add_argument("--steps", type=int, default=0,
                   help="timed steps; default 30 on GPU, 6 on CPU")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--distinct", type=int, default=4,
                   help="prepared batches to cycle through")
    p.add_argument("--virtual", type=int, default=0,
                   help="force N virtual CPU devices (smoke mode)")
    p.add_argument("--device", default="NVIDIA H100 80GB HBM3",
                   help="device_kind whose published peaks the analytic "
                        "column uses on a virtual mesh (on GPUs: their own)")
    p.add_argument("--profile_dir", default="",
                   help="capture a jax.profiler trace of each timed window")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args()


ARGS = _parse_args()

if ARGS.virtual:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={ARGS.virtual}"
        ).strip()

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from jax import shard_map  # noqa: E402

if ARGS.virtual:
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from peaks import peaks  # noqa: E402
from scaling_model import model_step  # noqa: E402

from ftrl_ffm_tpu.config import Config  # noqa: E402
from ftrl_ffm_tpu.models import make_model  # noqa: E402
from ftrl_ffm_tpu.parallel import ShardedStep, make_mesh, shard_state  # noqa: E402


def _defaults():
    on_gpu = jax.default_backend() == "gpu"
    b_dev = ARGS.b_dev or (4096 if on_gpu else 64)
    rows = ARGS.rows or (1_000_000 if on_gpu else 4096)
    steps = ARGS.steps or (30 if on_gpu else 6)
    return b_dev, rows, steps


def _make_batches(rng, cfg, n_batches):
    """Synthetic canonical-shaped batches (uniform ids, random vals)."""
    b, f = cfg.batch_size, cfg.max_nnz
    out = []
    for _ in range(n_batches):
        fields = np.tile(
            np.arange(f, dtype=np.int32) % cfg.n_fields, (b, 1)
        )
        feats = rng.integers(0, cfg.n_feats, (b, f)).astype(np.int32)
        vals = rng.random((b, f), dtype=np.float32)
        y = (rng.random(b) > 0.5).astype(np.float32)
        sample_w = np.ones(b, np.float32)
        out.append((fields, feats, vals, y, sample_w))
    return out


def _collective_probe(step: ShardedStep, cfg: Config, mesh):
    """Jitted probe that runs ONLY the step's wire legs, same shapes.

    Returns None when the mesh has no collectives (1x1 replicate)."""
    d, m = mesh.shape["data"], mesh.shape["model"]
    e = cfg.row_width
    legs = []
    if step.mode == "route" and m > 1:
        k = step.route_k
        legs.append(("a2a_ids", (m, k), jnp.int32))
        legs.append(("a2a_rows", (m, k, e), jnp.float32))
        legs.append(("a2a_pay", (m, k, 2 * e), jnp.float32))
    if d > 1:
        # replicate/hybrid dense path all-reduces the [rows_local, 2E]
        # accumulator over "data" (sharded.py::_table_update_routed /
        # _table_update); route+inplace on (1,N) has no such leg.
        legs.append(("psum_acc", (step.rows_local, 2 * e), jnp.float32))
    if step.mode == "replicate" and m > 1:
        # replicate-mode lookups psum [b_local, nnz(, E)] over "model"
        b_local = cfg.batch_size // d
        legs.append(("psum_lookup", (b_local * cfg.max_nnz, e), jnp.float32))
    if not legs:
        return None

    def probe():
        tot = jnp.zeros((), jnp.float32)
        for name, shape, dt in legs:
            buf = jnp.ones(shape, dt)
            if name.startswith("a2a"):
                out = jax.lax.all_to_all(buf, "model", 0, 0, tiled=True)
            elif name == "psum_acc":
                out = jax.lax.psum(buf, "data")
            else:
                out = jax.lax.psum(buf, "model")
            tot = tot + jnp.sum(out).astype(jnp.float32)
        return jax.lax.pmean(tot, ("data", "model"))

    return jax.jit(
        shard_map(probe, mesh=mesh, in_specs=(), out_specs=P(),
                  check_vma=False)
    )


def _sync(x):
    """Wait until the device has finished computing x."""
    jax.block_until_ready(x)


def _time_calls(fn, n, *args):
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / n


def bench_mesh(dm: tuple, b_dev: int, rows: int, steps: int, first=None):
    d, m = dm
    n_dev = d * m
    if n_dev > len(jax.devices()):
        return None
    mesh = make_mesh(d, m)
    cfg = Config(
        model_type=ARGS.model,
        n_feats=rows,
        n_fields=ARGS.fields,
        n_factors=ARGS.factors,
        max_nnz=ARGS.max_nnz,
        batch_size=b_dev * n_dev,
        mesh_data=d,
        mesh_model=m,
        lookup_mode=ARGS.lookup_mode,
    )
    model = make_model(cfg)
    sstate = shard_state(model.init(), mesh)
    step = ShardedStep(cfg, mesh, sstate)
    rng = np.random.default_rng(ARGS.seed)
    batches = [step.place_batch(a)
               for a in _make_batches(rng, cfg, ARGS.distinct)]
    jax.block_until_ready(batches)

    state = sstate
    for i in range(ARGS.warmup):
        state, *_ = step.train_step(state, batches[i % len(batches)])
    _sync(state.bias_n)

    ctx = None
    if ARGS.profile_dir:
        ctx = jax.profiler.trace(
            os.path.join(ARGS.profile_dir, f"mesh_{d}x{m}")
        )
        ctx.__enter__()
    t0 = time.perf_counter()
    for i in range(steps):
        state, *_ = step.train_step(state, batches[i % len(batches)])
    _sync(state.bias_n)
    step_s = (time.perf_counter() - t0) / steps
    if ctx is not None:
        ctx.__exit__(None, None, None)

    probe = _collective_probe(step, cfg, mesh)
    coll_s = 0.0
    if probe is not None:
        _sync(probe())  # compile
        coll_s = _time_calls(probe, max(steps, 10))

    kind = (ARGS.device if jax.default_backend() == "cpu"
            else jax.devices()[0].device_kind)
    pk = peaks(kind)
    analytic = model_step(d, m, b_dev, ARGS.max_nnz, ARGS.factors, rows,
                          pk["link_bytes_per_s"] / 1e9,
                          pk["hbm_bytes_per_s"] / 1e9)
    ex_s = cfg.batch_size / step_s
    per_dev = ex_s / n_dev
    row = {
        "mesh": f"{d}x{m}",
        "n_dev": n_dev,
        "mode": step.mode,
        "global_batch": cfg.batch_size,
        "step_ms": round(step_s * 1e3, 3),
        "ex_s": round(ex_s),
        "ex_s_per_dev": round(per_dev),
        "coll_probe_ms": round(coll_s * 1e3, 3),
        "coll_share": round(coll_s / step_s, 4) if step_s else 0.0,
        "model_ms": round(analytic["total_ms"], 3),
    }
    if first is not None:
        row["eff_vs_first"] = round(per_dev / first, 4)
    return row


def main():
    b_dev, rows, steps = _defaults()
    backend = jax.default_backend()
    virtual = bool(ARGS.virtual) or backend == "cpu"
    meshes = []
    for tok in ARGS.meshes.split(","):
        dd, mm = tok.strip().lower().split("x")
        meshes.append((int(dd), int(mm)))
    print(
        f"# backend={backend} devices={len(jax.devices())} b_dev={b_dev} "
        f"rows={rows} steps={steps} model={ARGS.model}"
        + (" [VIRTUAL — shapes/plumbing only, timings are not device "
           "numbers]" if virtual else f" ({jax.devices()[0].device_kind})")
    )
    results = []
    first_per_dev = None
    for dm in meshes:
        row = bench_mesh(dm, b_dev, rows, steps, first_per_dev)
        if row is None:
            print(f"# skip {dm[0]}x{dm[1]}: needs {dm[0]*dm[1]} devices")
            continue
        if first_per_dev is None:
            first_per_dev = row["ex_s_per_dev"]
            row["eff_vs_first"] = 1.0
        results.append(row)
        print(
            f"{row['mesh']:>5} mode={row['mode']:<9} "
            f"step={row['step_ms']:>9.3f}ms  ex/s={row['ex_s']:>10,}  "
            f"per-dev={row['ex_s_per_dev']:>9,}  "
            f"eff={row['eff_vs_first']:>6.2%}  "
            f"coll={row['coll_probe_ms']:>7.3f}ms ({row['coll_share']:.1%})"
            f"  model={row['model_ms']:>8.3f}ms"
        )
    print(json.dumps({
        "harness": "bench_multichip",
        "backend": backend,
        "b_dev": b_dev,
        "rows": rows,
        "steps": steps,
        "virtual": virtual,
        "meshes": results,
    }))


if __name__ == "__main__":
    main()
