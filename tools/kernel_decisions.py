"""Time each hand-written kernel against what XLA makes of the plain version.

Runs on the GPU at the flagship FFM widths (39 fields, C'=40, K=16,
E=640, B=16384), inside the jitted train and eval steps the Trainer
builds, and prints one JSON line per measurement:

  * train step, R=100k rows (dense2 update): fused kernel vs XLA
  * eval step, R=100k rows: inference kernel vs XLA
  * train step, R=1M rows (in-place update): fused kernel vs XLA, and the
    kernel with a plain jnp.zeros accumulator in place of
    ftrl.py::scatter_sum (the form XLA copies a table around)

Each pair runs in turns (A, B, B, A) in one process, so both sides see
the same card and clocks.  Usage (one GPU):

    python tools/kernel_decisions.py [--steps 20] [--trace DIR]

--trace writes a profiler trace of a few steps of each train variant and
prints the device ops that take the most time.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

N_FIELDS, N_FACTORS, BATCH = 39, 16, 16384


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def criteo_batch(n_feats: int, seed: int = 0):
    """Canonical Criteo-shaped batch: one feature per field, value 1."""
    from ftrl_ffm_tpu.models import Batch

    rng = np.random.default_rng(seed)
    per = n_feats // N_FIELDS
    ids = rng.integers(0, per, (BATCH, N_FIELDS)) + np.arange(N_FIELDS) * per
    return Batch(
        fields=jnp.asarray(np.tile(np.arange(N_FIELDS, dtype=np.int32),
                                   (BATCH, 1))),
        feats=jnp.asarray(ids.astype(np.int32)),
        vals=jnp.ones((BATCH, N_FIELDS), jnp.float32),
        y=jnp.asarray((rng.random(BATCH) > 0.75).astype(np.float32)),
        sample_w=jnp.ones((BATCH,), jnp.float32),
    )


def trainer(n_feats: int, use_pallas: str):
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    cfg = Config(
        model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS,
        n_feats=n_feats, batch_size=BATCH, max_nnz=N_FIELDS,
        file_type="libffm", use_pallas=use_pallas,
    )
    return Trainer(cfg)


def time_train(tr, batch, steps: int) -> float:
    """Mean seconds per donated train step after two warm-up steps."""
    for _ in range(2):
        tr.state = tr._train_step(tr.state, batch).state
    jax.block_until_ready(tr.state)
    t0 = time.perf_counter()
    for _ in range(steps):
        tr.state = tr._train_step(tr.state, batch).state
    jax.block_until_ready(tr.state)
    return (time.perf_counter() - t0) / steps


def time_eval(tr, batch, steps: int) -> float:
    f = jax.jit(tr.model.eval_step)
    jax.block_until_ready(f(tr.state, batch))
    t0 = time.perf_counter()
    for _ in range(steps):
        out = f(tr.state, batch)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / steps


def trace_top(tr, batch, path: str, label: str, top: int = 12) -> list:
    """Profile three steps: busy time per trace line of the GPU planes, and
    the kernels (events on the Stream lines) that take the most time, per
    step."""
    for _ in range(2):
        tr.state = tr._train_step(tr.state, batch).state
    jax.block_until_ready(tr.state)
    d = os.path.join(path, label)
    with jax.profiler.trace(d):
        for _ in range(3):
            tr.state = tr._train_step(tr.state, batch).state
        jax.block_until_ready(tr.state)
    from jax.profiler import ProfileData

    pb = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs
          if f.endswith(".xplane.pb")]
    prof = ProfileData.from_file(sorted(pb)[-1])
    tot: dict = {}
    lines: dict = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            busy = 0
            for ev in line.events:
                busy += ev.duration_ns
                if line.name.startswith("Stream"):
                    tot[ev.name] = tot.get(ev.name, 0) + ev.duration_ns
            lines[f"{plane.name} {line.name}"] = round(busy / 3e6, 3)
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return {"lines_ms_per_step": lines,
            "ops": [(name[:80], round(ns / 3e6, 3)) for name, ns in ranked]}


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _plain_scatter_sum(shape, ids, upd):
    return jnp.zeros(shape, upd.dtype).at[ids].add(upd, mode="drop")


_VARIANTS = {
    # name: (use_pallas, {module attr: replacement})
    "xla": ("off", {}),
    "kernel": ("on", {}),
    # the in-place update's accumulator without scatter_sum's barriers
    "kernel_plain_acc": (
        "on", {"ftrl_ffm_tpu.ftrl.scatter_sum": _plain_scatter_sum}
    ),
}


def _patched(patches):
    import contextlib
    import importlib

    @contextlib.contextmanager
    def ctx():
        saved = []
        for path, fn in patches.items():
            mod, attr = path.rsplit(".", 1)
            m = importlib.import_module(mod)
            saved.append((m, attr, getattr(m, attr)))
            setattr(m, attr, fn)
        # jitted callers keep their traces: drop them so the swap is seen
        jax.clear_caches()
        try:
            yield
        finally:
            for m, attr, fn in saved:
                setattr(m, attr, fn)
            jax.clear_caches()

    return ctx()


def step_compare(n_feats: int, steps: int, what: str, names, trace: str) -> None:
    batch = criteo_batch(n_feats)
    order = list(names) + list(reversed(names))
    times: dict = {n: [] for n in names}
    for name in order:
        mode, patches = _VARIANTS[name]
        with _patched(patches):
            tr = trainer(n_feats, mode)
            fn = time_train if what == "train" else time_eval
            times[name].append(round(fn(tr, batch, steps) * 1e3, 3))
            del tr
            gc.collect()
    emit(what=f"{what}_step", rows=n_feats, batch=BATCH, ms=times)
    if trace and what == "train":
        for name in names:
            mode, patches = _VARIANTS[name]
            with _patched(patches):
                tr = trainer(n_feats, mode)
                emit(what="trace_top", rows=n_feats, variant=name,
                     ops_ms_per_step=trace_top(tr, batch, trace,
                                               f"{n_feats}_{name}"))
                del tr
                gc.collect()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", default="")
    args = ap.parse_args()
    from ftrl_ffm_tpu.train import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    print(card(), flush=True)
    emit(device=dev.device_kind, jax=jax.__version__,
         xla_flags=os.environ.get("XLA_FLAGS", ""))
    step_compare(100_000, args.steps, "train", ["xla", "kernel"], args.trace)
    step_compare(100_000, args.steps, "eval", ["xla", "kernel"], "")
    step_compare(1_000_000, args.steps, "train",
                 ["xla", "kernel", "kernel_plain_acc"], args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
