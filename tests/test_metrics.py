"""Loss / AUC metric tests, pinned to the reference's unit-test values
(reference: tests/test_utils.cpp:20-43)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ftrl_ffm_tpu.metrics import LossAccumulator, StreamingAUC, exact_auc
from ftrl_ffm_tpu.models.base import binary_logloss


def test_reference_loss_values():
    # loss(y=1, logit=2) ~= 0.1269, loss(y=0, logit=1) ~= 1.3133
    assert float(binary_logloss(jnp.array(2.0), jnp.array(1.0))) == pytest.approx(
        0.126928, abs=1e-4
    )
    assert float(binary_logloss(jnp.array(1.0), jnp.array(0.0))) == pytest.approx(
        1.313262, abs=1e-4
    )


def test_sigmoid_reference_value():
    import jax

    assert float(jax.nn.sigmoid(jnp.array(1.0))) == pytest.approx(0.7311, abs=1e-4)


def test_loss_extreme_logits_finite():
    l = binary_logloss(jnp.array([40.0, -40.0]), jnp.array([0.0, 1.0]))
    assert np.all(np.isfinite(np.asarray(l)))


def test_loss_accumulator():
    acc = LossAccumulator()
    acc.update(10.0, 4)
    acc.update(2.0, 2)
    assert acc.mean == pytest.approx(2.0)
    acc.reset()
    assert np.isnan(acc.mean)


def test_streaming_auc_matches_exact():
    rng = np.random.default_rng(0)
    n = 20000
    labels = (rng.random(n) < 0.3).astype(np.float32)
    # informative scores
    logits = (labels * 2 - 1) * rng.random(n) * 3 + rng.standard_normal(n)
    scores = 1 / (1 + np.exp(-logits))

    auc = StreamingAUC(8192)
    for s in range(0, n, 4096):
        pos, neg = StreamingAUC.bucket_counts(
            jnp.asarray(logits[s : s + 4096]),
            jnp.asarray(labels[s : s + 4096]),
            jnp.ones(min(4096, n - s), jnp.float32),
            8192,
        )
        auc.update(pos, neg)
    ref = exact_auc(scores, labels)
    assert auc.result() == pytest.approx(ref, abs=2e-3)


def test_streaming_auc_error_at_scale_realistic():
    """Quantify the histogram-AUC bin error on a 400k-score Criteo-like
    distribution (scores concentrated near the base CTR, where uniform
    sigmoid bins are coarsest).  The half-tie correction in
    StreamingAUC.result makes within-bin ties nearly unbiased: measured
    error at AUC_BINS=8192 is ~2e-6 here (and ~4e-6 even at a pathological
    spread of 0.02) — far under the 1e-4 requirement, so no bins bump is
    needed."""
    from ftrl_ffm_tpu.metrics import AUC_BINS

    rng = np.random.default_rng(1)
    n = 400_000
    # tight logit spread around logit(0.25): early-FTRL-like concentration
    logits = -1.1 + 0.1 * rng.standard_normal(n)
    p = 1 / (1 + np.exp(-(logits * 1.5 + 0.3 * rng.standard_normal(n))))
    labels = (rng.random(n) < p).astype(np.float64)
    scores = 1 / (1 + np.exp(-logits))

    # host-side binning (identical math to bucket_counts, minus jit)
    idx = np.clip((scores * AUC_BINS).astype(np.int64), 0, AUC_BINS - 1)
    auc = StreamingAUC(AUC_BINS)
    auc.pos = np.bincount(idx, weights=labels, minlength=AUC_BINS).astype(
        np.float64
    )
    auc.neg = np.bincount(idx, weights=1 - labels, minlength=AUC_BINS).astype(
        np.float64
    )
    ref = exact_auc(scores, labels)
    assert abs(auc.result() - ref) < 1e-4


def test_auc_perfect_and_random():
    labels = np.array([0, 0, 1, 1], np.float32)
    assert exact_auc(np.array([0.1, 0.2, 0.8, 0.9]), labels) == 1.0
    assert exact_auc(np.array([0.9, 0.8, 0.2, 0.1]), labels) == 0.0
    assert exact_auc(np.array([0.5, 0.5, 0.5, 0.5]), labels) == 0.5


def test_kahan_accumulation_survives_adversarial_magnitudes():
    """f32 chaining demonstrably drifts at pass-level
    magnitudes (a late-pass 1e8 accumulator swallows per-batch increments
    entirely), the compensated path doesn't — and XLA's jit must not
    algebraically simplify the compensation away."""
    import jax.numpy as jnp

    from ftrl_ffm_tpu.metrics import kahan_add

    big = jnp.float32(1.0e8)   # ulp(1e8) = 8: adding 1.0 is a no-op in f32
    one = jnp.float32(1.0)
    vec = jnp.full((16,), 1.0e8, jnp.float32)

    naive = big
    for _ in range(2048):
        naive = naive + one
    assert float(naive) == 1.0e8  # the drift this test guards against

    sums = (big, vec)
    comps = (jnp.zeros_like(big), jnp.zeros_like(vec))
    for _ in range(2048):
        sums, comps = kahan_add(sums, comps, (one, jnp.ones_like(vec)))
    assert float(sums[0]) == 100002048.0
    np.testing.assert_array_equal(np.asarray(sums[1]), 100002048.0)


def test_train_epoch_pass_level_f64_accumulation():
    """Cross-step loss accounting is f64 on host: a step-sum stream whose
    f32 running sum demonstrably drifts must come out exact."""
    # 8192 step sums of ~0.69 * 16384 (a 1.3e8-example pass): f32
    # sequential chaining loses thousands once the running sum is ~1e8
    vals = np.full(8192, 11316.7, np.float32)
    f32_chain = np.float32(0.0)
    for v in vals:
        f32_chain = np.float32(f32_chain + v)
    exact = float(np.sum(vals, dtype=np.float64))
    assert abs(f32_chain - exact) > 1000.0  # the drift
    # the path train_epoch now takes: host f64 over the stacked step sums
    assert abs(float(np.sum(vals, dtype=np.float64)) - exact) == 0.0


def test_binned_auc_error_bound_adversarial():
    """The histogram AUC's a-posteriori bound
    (StreamingAUC.error_bound: 0.5·Σ pos_b·neg_b / (P·N) — only within-bin
    pairs can be mis-ranked, by at most 0.5 each) must hold on adversarial
    score distributions clustered near the threshold, where the histogram
    genuinely loses ranking information, and must be tiny on spread-out
    scores."""
    from ftrl_ffm_tpu.metrics import AUC_BINS

    rng = np.random.default_rng(0)
    n = 4096

    def run(scores, labels):
        auc = StreamingAUC(AUC_BINS)
        logits = np.log(scores / (1.0 - scores))
        pos, neg = StreamingAUC.bucket_counts(
            jnp.asarray(logits, jnp.float32),
            jnp.asarray(labels, jnp.float32),
            jnp.ones(len(scores), jnp.float32),
            AUC_BINS,
        )
        auc.update(pos, neg)
        return auc.result(), auc.error_bound(), exact_auc(scores, labels)

    # Adversarial: perfectly separable but everything inside ~1 bucket
    # around 0.5 — binned collapses toward 0.5; the bound must admit it.
    labels = (rng.random(n) < 0.5).astype(np.float32)
    eps = 1.0 / AUC_BINS / 16.0
    center = (AUC_BINS // 2 + 0.5) / AUC_BINS  # mid-bucket, not a bucket edge
    scores = center + (labels - 0.5) * eps  # pos slightly above, neg below
    binned, bound, exact = run(scores, labels)
    assert exact == 1.0
    assert abs(binned - exact) > 0.2      # the histogram really is blind here
    assert abs(binned - exact) <= bound + 1e-12
    assert bound >= 0.2                   # the bound honestly reports it

    # Clustered in a couple of buckets with noise: still within the bound.
    scores2 = np.clip(
        0.5 + (labels - 0.5) * eps + rng.normal(0, 4 * eps, n), 1e-6, 1 - 1e-6
    )
    binned2, bound2, exact2 = run(scores2, labels)
    assert abs(binned2 - exact2) <= bound2 + 1e-12

    # Spread-out scores: bound collapses to O(1/AUC_BINS) and the binned
    # estimate is accordingly tight.
    scores3 = np.clip(rng.random(n), 1e-6, 1 - 1e-6)
    labels3 = (rng.random(n) < scores3).astype(np.float32)
    binned3, bound3, exact3 = run(scores3, labels3)
    assert bound3 <= 2.0 / AUC_BINS
    assert abs(binned3 - exact3) <= bound3 + 1e-12


@pytest.mark.parametrize(
    "kw",
    [
        dict(online=True, device_cache="off"),            # streamed
        dict(online=False, device_cache="on"),            # cached gather
        dict(online=True, device_cache="off", mesh_model=2),   # sharded
        dict(online=False, device_cache="on", mesh_model=8,
             lookup_mode="route",
             device_cache_layout="replicate"),            # sharded + cached
    ],
)
def test_auc_mode_exact_end_to_end(tmp_path, kw):
    """--auc_mode exact: Trainer.evaluate computes the
    exact rank AUC — it must (a) match exact_auc on the model's own scores
    and (b) sit within the binned twin's a-posteriori error bound; eval
    loss is identical in both modes (same math, different AUC path)."""
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    rng = np.random.default_rng(4)
    tr_path, ev_path = str(tmp_path / "t.ffm"), str(tmp_path / "e.ffm")
    for path, seed in ((tr_path, 0), (ev_path, 1)):
        r = np.random.default_rng(seed)
        with open(path, "w") as f:
            for _ in range(64):
                toks = [str(int(r.random() > 0.5))] + [
                    f"{c}:{int(r.integers(c * 10, (c + 1) * 10))}:1"
                    for c in range(4)
                ]
                f.write(" ".join(toks) + "\n")
    base = dict(
        train_data=tr_path, eval_data=ev_path, model_type="FFM",
        n_fields=4, n_feats=40, n_factors=4, n_epochs=2, batch_size=16,
        w_alpha=0.05, w_l1=0.15, w_l2=1.0, **kw,
    )
    t_ex = Trainer(Config(**base, auc_mode="exact"))
    t_bin = Trainer(Config(**base, auc_mode="binned"))
    h_ex, h_bin = t_ex.train(), t_bin.train()
    np.testing.assert_allclose(h_ex["eval_loss"], h_bin["eval_loss"], rtol=1e-6)
    # the exact value differs from binned by at most the histogram's bound
    # (loose check; the tight oracle check is below)
    for a, b in zip(h_ex["eval_auc"], h_bin["eval_auc"]):
        assert 0.0 <= a <= 1.0 and abs(a - b) < 0.05
    # oracle: score the eval file with the SAME state and compare ranks
    out = str(tmp_path / "preds.txt")
    t_ex.predict_file(ev_path, out)
    scores = np.loadtxt(out)
    labels = np.array(
        [int(ln.split()[0]) > 0 for ln in open(ev_path)], np.float32
    )
    want = exact_auc(scores, labels)
    assert h_ex["eval_auc"][-1] == pytest.approx(want, abs=1e-6)


def test_auc_mode_exact_rejects_scan_grouping():
    from ftrl_ffm_tpu.config import Config

    with pytest.raises(ValueError, match="auc_mode=exact"):
        Config(model_type="LR", auc_mode="exact", steps_per_call=4)
