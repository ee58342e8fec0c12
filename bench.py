"""Headline benchmark: FFM (k=16) training throughput at Criteo scale.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "examples/s", "runs": [...], ...}

Workload: synthetic Criteo-shaped libffm data (400k samples, 39 fields, one
feature per field, 100k feature ids) trained with FFM n_factors=16, FTRL
defaults, online (streaming single-pass) mode, full host parse + device
train pipeline.  One warm-up epoch (compilation, device-cache fill), then
three timed epochs.  Needs a GPU: on any other backend it exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_SAMPLES = 400_000
N_FIELDS = 39
N_FEATS = 100_000
N_FACTORS = 16
BATCH = int(os.environ.get("FTRL_BENCH_BATCH", "16384"))


def write_criteo(
    path: str, n_samples: int, n_feats: int = N_FEATS, seed: int = 7
) -> str:
    """Deterministic synthetic Criteo-shaped libffm file: field c draws its
    one feature from its own n_feats/39 id range; labels follow a noisy
    linear model of the ids."""
    rng = np.random.default_rng(seed)
    per = n_feats // N_FIELDS
    ids = rng.integers(0, per, (n_samples, N_FIELDS)) + np.arange(N_FIELDS) * per
    w = rng.normal(0, 0.3, n_feats)
    logit = w[ids].sum(axis=1) + rng.normal(0, 1, n_samples)
    y = (logit > 0).astype(int)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for i in range(n_samples):
            toks = [str(y[i])] + [f"{c}:{ids[i, c]}:1" for c in range(N_FIELDS)]
            f.write(" ".join(toks) + "\n")
    os.replace(tmp, path)
    return path


def card() -> str:
    """`name, power.limit` of the first GPU, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import jax

    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer, enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    enable_compilation_cache()
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = write_criteo(os.path.join(tmp, "criteo.ffm"), N_SAMPLES)
        cfg = Config(
            train_data=path,
            model_type="FFM",
            n_fields=N_FIELDS,
            n_feats=N_FEATS,
            n_factors=N_FACTORS,
            online=True,
            # 1 warm-up + 3 timed epochs: declaring it lets device_cache=auto
            # replay the device-resident dataset in file order on epochs 2+
            # (the reference's rewind + re-read semantics)
            n_epochs=4,
            batch_size=BATCH,
            max_nnz=N_FIELDS,
            n_threads=3,
            use_pallas=os.environ.get("FTRL_BENCH_PALLAS", "auto"),
        )
        trainer = Trainer(cfg)
        trainer.train_epoch()  # warm-up: compile + cache fill, untimed
        jax.block_until_ready(trainer.state.lin_z)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            trainer.train_epoch()
            jax.block_until_ready(trainer.state.lin_z)
            times.append(time.perf_counter() - t0)
    print(
        json.dumps(
            {
                "metric": "ffm_k16_criteo_scale_online_train_throughput",
                "value": round(N_SAMPLES / min(times), 1),
                "unit": "examples/s",
                "runs": [round(N_SAMPLES / t, 1) for t in times],
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "use_pallas": cfg.use_pallas,
                "device_cache": trainer._dev_cache.get("train") is not None,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
