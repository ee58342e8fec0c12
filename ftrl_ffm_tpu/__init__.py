"""ftrl_ffm_tpu — an FTRL-Proximal CTR-training framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C++ framework massquantity/Ftrl-FFM (LR / FM / FFM binary classifiers trained
with FTRL-Proximal on libsvm / libffm data, online or offline, with
zstd-compressed model serialization).

Design notes (batched accelerator design, not a port):
  * The reference trains one sample at a time across CPU threads with
    per-feature-row mutexes (hogwild-style).  Here the same math is expressed
    as deterministic **mini-batch FTRL**: gather touched rows -> compute
    logits -> per-sample grads -> within-batch dedup (sorted segment-sum)
    -> one closed-form update + scatter.  Batch size 1 reproduces the
    reference's per-sample semantics exactly (minus its data races).
  * Weights are a pure function of the accumulators:  w = f(n, z)  — the
    reference's "lazy weight materialization"
    (reference: src/model/ftrl_model.cpp:52-59) made functional.
  * Scaling is jax.sharding over a ("data", "model") Mesh: batch sharded on
    "data", feature-row tables sharded on "model", all-to-all lookup routing
    — not threads and mutexes.
"""

from ftrl_ffm_tpu.config import Config
from ftrl_ffm_tpu.ftrl import FtrlParams, ftrl_weights
from ftrl_ffm_tpu.models import FFM, FM, LR, make_model

__version__ = "0.1.0"

__all__ = [
    "Config",
    "FtrlParams",
    "ftrl_weights",
    "LR",
    "FM",
    "FFM",
    "make_model",
    "__version__",
]
