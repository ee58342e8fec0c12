"""End-to-end benchmark matrix over several data/config variants.

Each row is a full Trainer run (host parse + device pipeline) on synthetic
Criteo-shaped data, timed like bench.py (best epoch of 2 after a warm-up
epoch).  Run from the repo root on a GPU host:

    python tools/bench_matrix.py [row ...]

rows (default: ffm fm lr):
    ffm      FFM k=16, 100k feats, online        (the bench.py headline)
    fm       FM k=16, online
    lr       LR, online
    ffm1m    FFM k=16, 1M feature rows, online   (huge-table in-place path)
    offline  FFM k=16, offline (in-memory, shuffled)
    eval     FFM k=16 eval/serving throughput (inference kernel)
    zipf     FFM k=16 on Zipf(s=1.1)-skewed ids  (realism: hot-key CTR data;
             also reports the scatter dedup ratio + delta-encode hit rate)
    numeric  FFM k=16 with one real-valued field (realism: exercises the
             f32 vals upload fallback — no int8/ones narrowing possible)
    noncanon FFM k=16 on fully non-canonical data: fractional values,
             variable nnz (padding-heavy short lines + truncation-warned
             long ones), shuffled token order (per-column id spreads
             exceed uint16 — delta encoding disabled).  The feeder path
             with NONE of the zero-width/delta/int8 fast paths; regressions
             off the canonical path show here.  (Fractional sample weights
             cannot occur on file-driven runs — the libsvm/libffm formats
             carry no weight column, so sample_w is always {0, 1}.)
Env: ROWS_SAMPLES (400000), ACC_DTYPE, TABLE_DTYPE, DEVICE_CACHE,
DEVICE_CACHE_COMPACT, FEED_WORKERS forwarded to Config.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_SAMPLES = int(os.environ.get("ROWS_SAMPLES", 400_000))
N_FIELDS = 39


def ensure_data(n_feats: int, variant: str = "uniform") -> str:
    """Synthetic Criteo-shaped libffm data.  Variants:
    uniform — one uniform-random feature per field, all values 1.0;
    zipf    — Zipf(s=1.1)-skewed ids within each field's vocab (heavy-tailed
              real-CTR id distribution; reference data contract per
              python/generate_data.py:200-203's offset vocab);
    numeric — field 0 carries a real-valued feature (like the bundled
              data's one numeric field, reference data/libsvm_data.txt),
              matching generate_data.py:188-197's MinMax-normalized floats.
    """
    path = os.path.join(
        tempfile.gettempdir(),
        f"ftrl_ffm_bench_{N_SAMPLES}_{n_feats}_{variant}.txt",
    )
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return path
    rng = np.random.default_rng(7)
    per = n_feats // N_FIELDS
    if variant == "zipf":
        ranks = rng.zipf(1.1, (N_SAMPLES, N_FIELDS))
        ids = np.minimum(ranks - 1, per - 1) + np.arange(N_FIELDS) * per
    else:
        ids = (
            rng.integers(0, per, (N_SAMPLES, N_FIELDS))
            + np.arange(N_FIELDS) * per
        )
    w = rng.normal(0, 0.3, n_feats)
    logit = w[ids].sum(axis=1) + rng.normal(0, 1, N_SAMPLES)
    y = (logit > 0).astype(int)
    numeric = (
        rng.random(N_SAMPLES).round(6) if variant == "numeric" else None
    )
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        if variant == "noncanon":
            # fully non-canonical rows: variable nnz (8..60 — short lines
            # pad, >39 truncate with the loader warning), fractional
            # values, shuffled token order (columns mix fields, so
            # per-column id spreads kill the uint16 delta encoding)
            for i in range(N_SAMPLES):
                nnz = int(rng.integers(8, 61))
                fs = (
                    rng.permutation(N_FIELDS)[:nnz]
                    if nnz <= N_FIELDS
                    else rng.integers(0, N_FIELDS, nnz)
                )
                toks = [str(y[i])] + [
                    f"{c}:{int(c) * per + int(rng.integers(0, per))}"
                    f":{rng.random() * 0.95 + 0.05:.6f}"
                    for c in fs
                ]
                f.write(" ".join(toks) + "\n")
        else:
            for i in range(N_SAMPLES):
                toks = [str(y[i])] + [
                    f"{c}:{ids[i, c]}:1" for c in range(N_FIELDS)
                ]
                if numeric is not None:
                    # real-valued numeric feature in field 0 (zero values
                    # are dropped by the parse contract, so floor at 1e-6)
                    toks[1] = f"0:{ids[i, 0]}:{max(numeric[i], 1e-6):.6f}"
                f.write(" ".join(toks) + "\n")
    os.replace(tmp, path)
    return path


def data_stats(path: str, batch: int = 8192) -> dict:
    """Host-side realism metrics over the first ~16 batches: scatter dedup
    ratio (unique ids / occurrences per batch — drives the update's
    aggregation win) and the delta-encode hit rate (fraction of batches
    whose per-column id ranges fit the uint16 delta encoding)."""
    from ftrl_ffm_tpu.data.stream import StreamReader

    reader = StreamReader(path, "libffm", batch, N_FIELDS, 10**9, N_FIELDS,
                          log_every=0)
    uniq_ratios, delta_hits, n = [], 0, 0
    for arrays in reader.batches():
        feats = arrays[1]
        uniq_ratios.append(np.unique(feats).size / feats.size)
        lo = feats.min(axis=0)
        hi = feats.max(axis=0)
        delta_hits += bool(((hi - lo) <= 65534).all())
        n += 1
        if n >= 16:
            break
    return {
        "dedup_ratio": round(float(np.mean(uniq_ratios)), 4),
        "delta_hit_rate": round(delta_hits / max(n, 1), 4),
    }


def run_row(row: str) -> dict:
    import jax

    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    n_feats = 1_000_000 if row == "ffm1m" else 100_000
    variant = row if row in ("zipf", "numeric", "noncanon") else "uniform"
    path = ensure_data(n_feats, variant)
    kw = dict(
        train_data=path,
        model_type={"fm": "FM", "lr": "LR"}.get(row, "FFM"),
        n_fields=N_FIELDS,
        n_feats=n_feats,
        n_factors=16,
        online=row != "offline",
        n_epochs=1,
        # 16384 is the measured-best batch since round 3's upload markers
        # (device +8.5% at 100k rows; at 1M rows it amortizes the fixed
        # O(R) closed-form pass: 114.6k -> 162.9k device-bound); the
        # offline row joined in round 4 — its cached epochs are device-
        # bound, so the bigger batch carries end to end (254-257k vs 233-
        # 239k at 8192)
        batch_size=16384 if row in ("ffm", "ffm1m", "offline") else 8192,
        max_nnz=N_FIELDS,
        n_threads=3,
        acc_dtype=os.environ.get("ACC_DTYPE", "float32"),
        table_dtype=os.environ.get("TABLE_DTYPE", "float32"),
        # offline row: auto engages the device-resident dataset when it fits
        # next to the state; DEVICE_CACHE=off measures the streamed feed
        device_cache=os.environ.get("DEVICE_CACHE", "auto"),
        device_cache_compact=os.environ.get("DEVICE_CACHE_COMPACT", "auto"),
        feed_workers=int(os.environ.get("FEED_WORKERS", "1")),
    )
    if kw["model_type"] == "FFM":
        kw["file_type"] = "libffm"
    trainer = Trainer(Config(**kw))
    trainer.train_epoch()  # warm-up: compile + page-in
    jax.block_until_ready(trainer.state.lin_z)
    cache = trainer._dev_cache.get("train")
    cache_tag = cache.layout if cache is not None else "streamed"

    if row == "eval":
        trainer.cfg.eval_data = path
        trainer.evaluate()  # warm-up: compile the eval/AUC jit
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            loss, auc = trainer.evaluate()
            times.append(time.perf_counter() - t0)
        ec = trainer._dev_cache.get("eval")
        return {"row": row, "examples_per_s": round(N_SAMPLES / min(times), 1),
                "eval_loss": round(loss, 4),
                "device_cache": ec.layout if ec is not None else "streamed"}

    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        loss = trainer.train_epoch()
        jax.block_until_ready(trainer.state.lin_z)
        times.append(time.perf_counter() - t0)
    out = {
        "row": row,
        "examples_per_s": round(N_SAMPLES / min(times), 1),
        "train_loss": round(loss, 4),
        "device_cache": cache_tag,
    }
    if variant != "uniform":
        out.update(data_stats(path))
        # which vals upload path engaged (ones marker / int8 / bf16 / f32)
        b = next(iter(trainer._train_batches(np.random.default_rng(0))))
        c = trainer._compact(b)
        out["vals_upload"] = (
            "ones-marker" if c[2].shape[-1] == 0 else str(c[2].dtype)
        )
        out["feats_upload"] = str(c[1].dtype)
    return out


def main() -> None:
    rows = sys.argv[1:] or ["ffm", "fm", "lr"]
    if len(rows) > 1:
        # one subprocess per row: rows contaminate each other in-process
        # (lingering device state + CPU contention measured eval at 184k
        # in sequence vs 548k alone)
        import subprocess

        for row in rows:
            subprocess.run(
                [sys.executable, os.path.abspath(__file__), row], check=True
            )
        return
    for row in rows:
        print(json.dumps(run_row(row)), flush=True)


if __name__ == "__main__":
    main()
