"""Config.field_pad row padding: padded-field FFM == unpadded FFM.

The flagship config (C=39, K=16) pads factor rows to C'=40 so E = 640 is an
exact 128-lane multiple (aligned gathers/scatters, natural row-major entry
layout, and a dead lane to carry the linear gradient).  Fields
[n_fields, field_pad) never occur, so all their contributions are zero and
results must match the unpadded model exactly (up to fp reassociation).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ftrl_ffm_tpu.config import Config


def test_field_pad_selection():
    # flagship: K=16, C=39 -> C'=40 (+2.6%)
    assert Config(model_type="FFM", n_fields=39, n_factors=16).field_pad == 40
    assert Config(model_type="FFM", n_fields=39, n_factors=16).row_width == 640
    assert Config(model_type="FFM", n_fields=39, n_factors=16).ref_row_width == 624
    # already aligned: C'=C
    assert Config(model_type="FFM", n_fields=16, n_factors=8).field_pad == 16
    # too expensive (K=8 needs multiples of 16: 39 -> 48, +23%): no padding
    assert Config(model_type="FFM", n_fields=39, n_factors=8).field_pad == 39
    # K=32 needs multiples of 4: 39 -> 40
    assert Config(model_type="FFM", n_fields=39, n_factors=32).field_pad == 40
    # FM / LR unaffected
    assert Config(model_type="FM", n_fields=39, n_factors=16).field_pad == 39
    assert Config(model_type="LR", n_fields=39).row_width == 0


def test_layout_roundtrip_with_padding():
    from ftrl_ffm_tpu.ops.layout import kmajor_to_reference, reference_to_kmajor

    rng = np.random.default_rng(0)
    r, c, k, cp = 7, 5, 4, 8
    ref = rng.normal(size=(r, c * k)).astype(np.float32)
    kmaj = reference_to_kmajor(ref, c, k, cp)
    assert kmaj.shape == (r, k * cp)
    # dead lanes are zero
    kmaj3 = kmaj.reshape(r, k, cp)
    np.testing.assert_array_equal(kmaj3[:, :, c:], 0.0)
    back = kmajor_to_reference(kmaj, c, k, cp)
    np.testing.assert_array_equal(back, ref)


@pytest.mark.parametrize("use_pallas", ["off", "interpret"])
def test_padded_trajectory_matches_unpadded(use_pallas, tmp_path, monkeypatch):
    """Training with field_pad forced off == training with padding on
    (C=39, K=16 so padding engages), several chained steps, both kernel
    paths."""
    from ftrl_ffm_tpu.models import Batch, make_model
    from tests.common import interpret_kernels

    if use_pallas == "interpret":
        interpret_kernels(monkeypatch)

    rng = np.random.default_rng(11)
    b, c, k, r, f = 16, 39, 16, 128, 6
    kw = dict(
        model_type="FFM", n_fields=c, n_feats=r, n_factors=k,
        batch_size=b, max_nnz=f, factor_semantics="reference",
        use_pallas="on" if use_pallas == "interpret" else "off",
    )
    cfg_pad = Config(**kw)
    assert cfg_pad.field_pad == 40
    cfg_nopad = Config(**kw)
    monkeypatch.setattr(
        Config, "field_pad", property(lambda self: self.n_fields)
    )
    assert cfg_nopad.field_pad == 39
    m_nopad = make_model(cfg_nopad)
    st_nopad = m_nopad.init()
    monkeypatch.undo()
    if use_pallas == "interpret":
        interpret_kernels(monkeypatch)
    m_pad = make_model(cfg_pad)
    st_pad = m_pad.init()
    assert st_pad.vec_n.shape == (r, 640)
    assert st_nopad.vec_n.shape == (r, 624)

    losses_pad, losses_nopad = [], []
    for i in range(3):
        batch = Batch(
            fields=jnp.asarray(rng.integers(0, c, (b, f)).astype(np.int32)),
            feats=jnp.asarray(rng.integers(0, r, (b, f)).astype(np.int32)),
            vals=jnp.asarray(rng.random((b, f)).astype(np.float32)),
            y=jnp.asarray((rng.random(b) > 0.5).astype(np.float32)),
            sample_w=jnp.asarray(np.ones(b, np.float32)),
        )
        out_pad = m_pad.train_step(st_pad, batch)
        out_nopad = m_nopad.train_step(st_nopad, batch)
        st_pad, st_nopad = out_pad.state, out_nopad.state
        losses_pad.append(float(out_pad.loss_sum))
        losses_nopad.append(float(out_nopad.loss_sum))
    np.testing.assert_allclose(losses_pad, losses_nopad, rtol=3e-4)
    # linear tables see identical updates (fp noise only)
    np.testing.assert_allclose(
        np.asarray(st_pad.lin_z), np.asarray(st_nopad.lin_z),
        rtol=2e-3, atol=5e-5,
    )
    # factor tables match on real lanes (dead lanes shadow linear stats)
    pad3 = np.asarray(st_pad.vec_z).reshape(r, k, 40)[:, :, :39]
    nop3 = np.asarray(st_nopad.vec_z).reshape(r, k, 39)
    np.testing.assert_allclose(pad3, nop3, rtol=2e-3, atol=5e-5)


def test_export_import_roundtrip_with_padding(tmp_path):
    """Reference-blob export drops dead lanes; import restores them as
    zeros; materialized weights round-trip exactly."""
    from ftrl_ffm_tpu.models import make_model

    cfg = Config(
        model_type="FFM", n_fields=39, n_feats=64, n_factors=16,
        factor_semantics="keep_init",
    )
    m = make_model(cfg)
    state = m.init()
    bias, lin_w, vec_w = m.materialize_weights(state)
    assert vec_w.shape == (64, 624)  # logical reference width
    st2 = m.init_from_weights(bias, lin_w, vec_w)
    bias2, lin_w2, vec_w2 = m.materialize_weights(st2)
    np.testing.assert_allclose(np.asarray(vec_w2), np.asarray(vec_w), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(lin_w2), np.asarray(lin_w), rtol=1e-6)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
@pytest.mark.parametrize("lookup_mode", ["replicate", "route"])
def test_sharded_padded_matches_single_device(mesh_shape, lookup_mode):
    """Padded FFM (C=39, K=16 -> E=640, linear mirrored in the dead lane):
    the sharded step — which reads the linear weight from the gathered
    rows instead of a second routed lookup — matches the single-device
    step on losses, logits and both tables."""
    import jax.numpy as jnp

    from ftrl_ffm_tpu.models import Batch, make_model
    from ftrl_ffm_tpu.parallel import (
        ShardedStep, make_mesh, shard_state, unshard_state,
    )

    cfg = Config(
        model_type="FFM", n_feats=96, n_fields=39, n_factors=16,
        batch_size=16, max_nnz=6, lookup_mode=lookup_mode,
    )
    assert cfg.field_pad == 40
    model = make_model(cfg)
    rng = np.random.default_rng(2)
    b, f = cfg.batch_size, cfg.max_nnz
    fields = rng.integers(0, 39, (b, f)).astype(np.int32)
    feats = rng.integers(0, cfg.n_feats, (b, f)).astype(np.int32)
    vals = rng.random((b, f)).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sample_w = np.ones(b, np.float32)
    feats[:, -1] = cfg.n_feats
    vals[:, -1] = 0.0
    arrays = (fields, feats, vals, y, sample_w)
    batch = Batch(*(jnp.asarray(a) for a in arrays))

    out1 = model.train_step(model.init(), batch)
    out2 = model.train_step(out1.state, batch)

    mesh = make_mesh(*mesh_shape)
    sstate = shard_state(model.init(), mesh)
    step = ShardedStep(cfg, mesh, sstate)
    sbatch = step.place_batch(arrays)
    sstate, logits, loss_sum, count, _ = step.train_step(sstate, sbatch)
    np.testing.assert_allclose(
        np.asarray(logits), np.asarray(out1.logits), rtol=1e-5, atol=1e-6
    )
    sstate, logits, loss_sum, count, _ = step.train_step(sstate, sbatch)
    np.testing.assert_allclose(
        float(loss_sum), float(out2.loss_sum), rtol=1e-5
    )
    lstate = unshard_state(sstate, mesh.shape["model"], cfg.n_feats)
    np.testing.assert_allclose(
        np.asarray(lstate.lin_z), np.asarray(out2.state.lin_z),
        rtol=1e-4, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(lstate.vec_z), np.asarray(out2.state.vec_z),
        rtol=1e-4, atol=1e-6,
    )
    # the mirror invariant holds on the unsharded state too
    np.testing.assert_allclose(
        np.asarray(lstate.vec_z[:, 39]), np.asarray(lstate.lin_z),
        rtol=1e-5, atol=1e-7,
    )


def test_linear_mirror_invariant_all_paths(monkeypatch):
    """vec lane (0, n_fields) mirrors the linear table after training
    through (a) the XLA path, (b) the fused-kernel aug path (interpret),
    (c) the forced in-place huge-table path."""
    import jax.numpy as jnp

    from tests.common import interpret_kernels

    import ftrl_ffm_tpu.models.base as base_mod
    from ftrl_ffm_tpu.models import Batch, make_model

    rng = np.random.default_rng(3)
    b, c, k, r, f = 16, 39, 16, 64, 5

    models = {}

    def run(use_pallas, update_mode="auto", interpret=False):
        if interpret:
            interpret_kernels(monkeypatch)
        cfg = Config(
            model_type="FFM", n_fields=c, n_feats=r, n_factors=k,
            batch_size=b, max_nnz=f, use_pallas=use_pallas,
            update_mode=update_mode,
        )
        m = make_model(cfg)
        st = m.init()
        rng2 = np.random.default_rng(4)
        for _ in range(3):
            batch = Batch(
                fields=jnp.asarray(rng2.integers(0, c, (b, f)).astype(np.int32)),
                feats=jnp.asarray(rng2.integers(0, r, (b, f)).astype(np.int32)),
                vals=jnp.asarray(rng2.random((b, f)).astype(np.float32)),
                y=jnp.asarray((rng2.random(b) > 0.5).astype(np.float32)),
                sample_w=jnp.asarray(np.ones(b, np.float32)),
            )
            st = m.train_step(st, batch).state
        monkeypatch.undo()
        models[use_pallas] = m
        return st

    for name, st in (
        ("xla", run("off")),
        ("pallas-aug", run("on", interpret=True)),
        ("xla-inplace", None),
    ):
        if name == "xla-inplace":
            orig = base_mod.select_update_kind
            monkeypatch.setattr(
                base_mod, "select_update_kind",
                lambda rr, d, nn, mode: "inplace" if d else orig(rr, d, nn, mode),
            )
            st = run("off")
            monkeypatch.undo()
            # the in-place path intentionally skips the separate linear
            # update (lin arrays ride stale); the boundary sync must
            # reconstruct them exactly from the mirror lane
            assert np.abs(np.asarray(st.lin_z)).max() == 0  # stale by design
            st = models["off"].sync_lin_from_mirror(st)
        np.testing.assert_allclose(
            np.asarray(st.vec_z[:, 39]), np.asarray(st.lin_z),
            rtol=1e-5, atol=1e-7, err_msg=f"z mirror broken ({name})",
        )
        np.testing.assert_allclose(
            np.asarray(st.vec_w[:, 39]), np.asarray(st.lin_w),
            rtol=1e-5, atol=1e-8, err_msg=f"w mirror broken ({name})",
        )
        assert np.abs(np.asarray(st.lin_z)).max() > 0  # training happened


def test_import_reference_restores_mirror():
    """Warm starts write the imported linear weights into the dead lane so
    the mirrored forward sees them."""
    from ftrl_ffm_tpu.models import make_model

    cfg = Config(
        model_type="FFM", n_fields=39, n_feats=32, n_factors=16,
        factor_semantics="reference",
    )
    m = make_model(cfg)
    rng = np.random.default_rng(5)
    lin_w = rng.normal(size=(32,)).astype(np.float32) * 0.1
    vec_w = rng.normal(size=(32, 624)).astype(np.float32) * 0.1
    st = m.init_from_weights(np.float32(0.3), lin_w, vec_w)
    np.testing.assert_allclose(np.asarray(st.vec_w[:, 39]), lin_w, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(st.vec_z[:, 39]), np.asarray(st.lin_z), rtol=1e-6
    )


def test_bf16_tables_keep_f32_linear_forward():
    """Under table_dtype=bfloat16 the forward must NOT read the (bf16-
    rounded) mirrored lane — it keeps the exact f32 lin_w gather; the
    mirror is still maintained for state consistency."""
    import jax.numpy as jnp

    from ftrl_ffm_tpu.models import Batch, make_model

    cfg16 = Config(
        model_type="FFM", n_fields=39, n_feats=64, n_factors=16,
        batch_size=16, max_nnz=5, table_dtype="bfloat16", use_pallas="off",
    )
    m16 = make_model(cfg16)
    assert m16._lin_lane() == 39
    assert m16._lin_read_lane() == -1  # forward keeps the f32 gather
    cfg32 = Config(
        model_type="FFM", n_fields=39, n_feats=64, n_factors=16,
        batch_size=16, max_nnz=5, use_pallas="off",
    )
    assert make_model(cfg32)._lin_read_lane() == 39

    # the mirror is still fed under bf16 tables (grad_lane active), but
    # only to bf16 precision: the lane's sigma*w term uses the bf16-stored
    # w while lin_z uses exact f32 lin_w — which is exactly why the
    # forward doesn't read the lane under bf16 tables
    rng = np.random.default_rng(6)
    b, f = 16, 5
    st = m16.init()
    for _ in range(2):
        batch = Batch(
            fields=jnp.asarray(rng.integers(0, 39, (b, f)).astype(np.int32)),
            feats=jnp.asarray(rng.integers(0, 64, (b, f)).astype(np.int32)),
            vals=jnp.asarray(rng.random((b, f)).astype(np.float32)),
            y=jnp.asarray((rng.random(b) > 0.5).astype(np.float32)),
            sample_w=jnp.asarray(np.ones(b, np.float32)),
        )
        st = m16.train_step(st, batch).state
    np.testing.assert_allclose(
        np.asarray(st.vec_z[:, 39]), np.asarray(st.lin_z),
        rtol=2e-2, atol=1e-4,
    )
