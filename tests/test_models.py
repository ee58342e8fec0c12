"""Model parity tests: the batched device step at B=1 reproduces the sequential
per-sample reference algorithm (via the numpy oracle) for LR / FM / FFM."""

import jax.numpy as jnp
import numpy as np
import pytest

from ftrl_ffm_tpu.config import Config
from ftrl_ffm_tpu.models import Batch, make_model
from tests.reference_oracle import Oracle

N_FEATS = 50
N_FIELDS = 4
K = 3


def make_batch(samples, max_nnz, n_feats, batch_size=None):
    """samples: list of (fields, ids, vals, y)."""
    b = batch_size or len(samples)
    fields = np.zeros((b, max_nnz), np.int32)
    feats = np.full((b, max_nnz), n_feats, np.int32)
    vals = np.zeros((b, max_nnz), np.float32)
    y = np.zeros(b, np.float32)
    w = np.zeros(b, np.float32)
    for s, (fl, ids, vl, yy) in enumerate(samples):
        m = len(ids)
        fields[s, :m] = fl
        feats[s, :m] = ids
        vals[s, :m] = vl
        y[s] = yy
        w[s] = 1.0
    return Batch(*(jnp.asarray(a) for a in (fields, feats, vals, y, w)))


def random_samples(rng, n, n_feats=N_FEATS, n_fields=N_FIELDS, nnz=4):
    out = []
    for _ in range(n):
        ids = rng.choice(n_feats, size=nnz, replace=False)
        fields = rng.integers(0, n_fields, size=nnz)
        vals = rng.random(nnz).astype(np.float32) + 0.1
        y = int(rng.random() < 0.5)
        out.append((fields, ids, vals, y))
    return out


def _cfg(model_type, semantics="keep_init"):
    return Config(
        model_type=model_type,
        n_feats=N_FEATS,
        n_fields=N_FIELDS,
        n_factors=K,
        factor_semantics=semantics,
        batch_size=1,
    )


@pytest.mark.parametrize("model_type", ["LR", "FM", "FFM"])
@pytest.mark.parametrize("semantics", ["keep_init", "reference"])
def test_b1_trajectory_matches_oracle(model_type, semantics):
    cfg = _cfg(model_type, semantics)
    model = make_model(cfg)
    state = model.init()

    from ftrl_ffm_tpu.ops.layout import kmajor_to_reference

    def to_ref_layout(arr):
        # FFM factor rows are stored factor-major internally; the oracle
        # speaks the reference's field-major layout (ops/layout.py).
        if model_type == "FFM":
            return kmajor_to_reference(np.asarray(arr), N_FIELDS, K)
        return np.asarray(arr)

    vec_init = None
    if model_type != "LR" and semantics == "keep_init":
        # the freshly-initialized vec_w table IS the random init
        vec_init = to_ref_layout(state.vec_w).copy()
    oracle = Oracle(
        model_type,
        N_FEATS,
        N_FIELDS,
        K if model_type != "LR" else 0,
        vec_init=vec_init,
    )

    rng = np.random.default_rng(7)
    samples = random_samples(rng, 30)
    for t, (fl, ids, vl, y) in enumerate(samples):
        batch = make_batch([(fl, ids, vl, y)], max_nnz=6, n_feats=N_FEATS)
        out = model.train_step(state, batch)
        state = out.state
        ref_logit = oracle.train(fl, ids, vl, y)
        ours = float(out.logits[0])
        assert ours == pytest.approx(ref_logit, rel=2e-3, abs=2e-4), (
            f"step {t}: {ours} vs {ref_logit}"
        )

    # final accumulator tables match
    np.testing.assert_allclose(
        np.asarray(state.lin_z), oracle.lin_z, rtol=2e-3, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(state.lin_n), oracle.lin_n, rtol=2e-3, atol=2e-5
    )
    if model_type != "LR":
        np.testing.assert_allclose(
            to_ref_layout(state.vec_z), oracle.vec_z, rtol=2e-2, atol=2e-4
        )


@pytest.mark.parametrize("trial", range(6))
def test_b1_trajectory_matches_oracle_random_shapes(trial):
    """Property-style shape sweep of the oracle-trajectory parity: random
    (n_fields, n_factors, n_feats, nnz) per trial — catches shape-dependent
    bugs (field_pad dead lanes, odd K tiling, tiny tables) that the fixed
    flagship shape cannot."""
    shape_rng = np.random.default_rng(100 + trial)
    n_fields = int(shape_rng.integers(2, 12))
    k = int(shape_rng.choice([1, 2, 3, 4, 8, 16]))
    n_feats = int(shape_rng.integers(20, 300))
    nnz = int(shape_rng.integers(2, min(9, n_fields + 3)))
    model_type = ["LR", "FM", "FFM"][trial % 3]

    cfg = Config(
        model_type=model_type, n_feats=n_feats, n_fields=n_fields,
        n_factors=k, batch_size=1, max_nnz=nnz,
    )
    model = make_model(cfg)
    state = model.init()

    from ftrl_ffm_tpu.ops.layout import kmajor_to_reference

    def to_ref_layout(arr):
        if model_type == "FFM":
            return kmajor_to_reference(
                np.asarray(arr), n_fields, k, cfg.field_pad
            )
        return np.asarray(arr)

    vec_init = None
    if model_type != "LR":
        vec_init = to_ref_layout(state.vec_w).copy()
    oracle = Oracle(
        model_type, n_feats, n_fields,
        k if model_type != "LR" else 0, vec_init=vec_init,
    )
    rng = np.random.default_rng(200 + trial)
    for t in range(15):
        ids = rng.choice(n_feats, size=nnz, replace=False)
        fl = rng.integers(0, n_fields, size=nnz)
        vl = rng.random(nnz).astype(np.float32) + 0.1
        y = int(rng.random() < 0.5)
        out = model.train_step(
            state, make_batch([(fl, ids, vl, y)], nnz, n_feats)
        )
        state = out.state
        ref_logit = oracle.train(fl, ids, vl, y)
        assert float(out.logits[0]) == pytest.approx(
            ref_logit, rel=2e-3, abs=2e-4
        ), f"trial {trial} step {t} ({model_type} C={n_fields} K={k})"
    np.testing.assert_allclose(
        np.asarray(state.lin_z), oracle.lin_z, rtol=2e-3, atol=2e-4
    )
    if model_type != "LR":
        np.testing.assert_allclose(
            to_ref_layout(state.vec_z), oracle.vec_z, rtol=2e-2, atol=2e-4
        )


def test_reference_semantics_factor_collapse():
    """Under exact reference semantics, factors materialize to 0 on first
    touch (z=0 -> w=0) so factor grads vanish and FFM degenerates to LR —
    the behavior implied by reference src/model/ffm.cpp:72-88.  keep_init
    avoids this."""
    rng = np.random.default_rng(3)
    samples = random_samples(rng, 20)

    cfg_ref = _cfg("FFM", "reference")
    m_ref = make_model(cfg_ref)
    s_ref = m_ref.init()
    for fl, ids, vl, y in samples:
        s_ref = m_ref.train_step(s_ref, make_batch([(fl, ids, vl, y)], 6, N_FEATS)).state
    assert float(jnp.abs(s_ref.vec_z).sum()) == 0.0  # factors never moved

    cfg_ki = _cfg("FFM", "keep_init")
    m_ki = make_model(cfg_ki)
    s_ki = m_ki.init()
    for fl, ids, vl, y in samples:
        s_ki = m_ki.train_step(s_ki, make_batch([(fl, ids, vl, y)], 6, N_FEATS)).state
    assert float(jnp.abs(s_ki.vec_z).sum()) > 0.0  # factors trained


@pytest.mark.parametrize("model_type", ["LR", "FM", "FFM"])
def test_batched_equals_per_sample_when_ids_disjoint(model_type):
    """With disjoint feature ids across samples, one batched step of B samples
    must equal B sequential steps (no cross-sample interaction, bias aside)."""
    cfg = _cfg(model_type)
    model = make_model(cfg)

    rng = np.random.default_rng(11)
    samples = []
    pool = rng.permutation(N_FEATS)
    for s in range(4):
        ids = pool[s * 4 : s * 4 + 4]
        fields = np.arange(4) % N_FIELDS
        vals = rng.random(4).astype(np.float32) + 0.1
        samples.append((fields, ids, vals, int(rng.random() < 0.5)))

    state_b = model.init()
    out = model.train_step(state_b, make_batch(samples, 6, N_FEATS))

    # sequential with a frozen bias (zero its grad contribution by comparing
    # only the linear/vec tables of ids, which don't depend on bias updates
    # within the step since all reads happen before updates)
    state_s = model.init()
    for smp in samples:
        o = model.train_step(state_s, make_batch([smp], 6, N_FEATS))
        state_s = o.state
    # trajectories differ only through the shared bias (updated between
    # sequential steps); with alpha tiny the bias moves O(alpha), so tables
    # agree tightly.
    np.testing.assert_allclose(
        np.asarray(out.state.lin_z), np.asarray(state_s.lin_z), rtol=1e-3, atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.state.lin_n), np.asarray(state_s.lin_n), rtol=1e-3, atol=5e-6
    )


def test_predict_proba_range_and_padding():
    cfg = _cfg("FFM")
    model = make_model(cfg)
    state = model.init()
    rng = np.random.default_rng(5)
    samples = random_samples(rng, 3)
    batch = make_batch(samples, 6, N_FEATS, batch_size=8)  # 5 padded samples
    probs = np.asarray(model.predict_proba(state, batch))
    assert probs.shape == (8,)
    assert np.all((probs > 0) & (probs < 1))


def test_materialize_weights_shapes():
    for mt in ("LR", "FM", "FFM"):
        cfg = _cfg(mt)
        model = make_model(cfg)
        state = model.init()
        bias, lin_w, vec_w = model.materialize_weights(state)
        assert lin_w.shape == (N_FEATS,)
        if mt == "LR":
            assert vec_w is None
        elif mt == "FM":
            assert vec_w.shape == (N_FEATS, K)
        else:
            assert vec_w.shape == (N_FEATS, N_FIELDS * K)


def test_training_sparsifies_weights():
    """L1 actually produces exact zeros on trained linear weights — the
    reference's closest convergence assertion (tests/test_task.cpp asserts
    has_zero_weights)."""
    cfg = _cfg("LR")
    model = make_model(cfg)
    state = model.init()
    rng = np.random.default_rng(13)
    for _ in range(10):
        state = model.train_step(
            state, make_batch(random_samples(rng, 8), 6, N_FEATS, batch_size=8)
        ).state
    _, lin_w, _ = model.materialize_weights(state)
    assert np.any(np.asarray(lin_w) == 0.0)


def test_bfloat16_table_dtype_trains_and_roundtrips(tmp_path):
    """table_dtype=bfloat16: vec_w stored quantized, (n, z) stay f32; training
    works and checkpoints round-trip the dtype."""
    import jax.numpy as jnp
    from ftrl_ffm_tpu.io.checkpoint import load_checkpoint, save_checkpoint

    cfg = Config(
        model_type="FFM", n_feats=N_FEATS, n_fields=N_FIELDS, n_factors=K,
        table_dtype="bfloat16",
    )
    model = make_model(cfg)
    state = model.init()
    assert state.vec_w.dtype == jnp.bfloat16
    assert state.vec_n.dtype == jnp.float32
    rng = np.random.default_rng(21)
    for _ in range(5):
        state = model.train_step(
            state, make_batch(random_samples(rng, 8), 6, N_FEATS, batch_size=8)
        ).state
    assert state.vec_w.dtype == jnp.bfloat16
    assert float(jnp.abs(state.vec_z).sum()) > 0  # factors actually trained
    p = str(tmp_path / "bf16.ckpt")
    save_checkpoint(p, state)
    loaded, _ = load_checkpoint(p)
    assert loaded.vec_w.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(state.vec_w, dtype=np.float32),
        np.asarray(loaded.vec_w, dtype=np.float32),
    )
