"""Unit tests for the FTRL core (closed form, accumulate, dense table update)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ftrl_ffm_tpu.ftrl import (
    UNTOUCHED_N,
    FtrlParams,
    bias_update,
    dense_ftrl_update,
    ftrl_accumulate,
    ftrl_weights,
)
from tests.reference_oracle import closed_form

P = FtrlParams(alpha=1e-4, beta=1.0, l1=0.1, l2=5.0)


def test_closed_form_zero_region():
    n = jnp.zeros(5)
    z = jnp.array([0.0, 0.05, -0.1, 0.1, -0.09])
    w = ftrl_weights(n, z, P)
    assert np.allclose(np.asarray(w), 0.0)  # |z| <= l1 -> exactly 0


def test_closed_form_matches_oracle():
    rng = np.random.default_rng(0)
    n = rng.random(100).astype(np.float32) * 10
    z = (rng.standard_normal(100) * 3).astype(np.float32)
    ours = np.asarray(ftrl_weights(jnp.asarray(n), jnp.asarray(z), P))
    ref = closed_form(n, z, P.alpha, P.beta, P.l1, P.l2)
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_closed_form_sign():
    # large positive z -> negative weight; symmetric for negative z
    w_pos = float(ftrl_weights(jnp.array(1.0), jnp.array(5.0), P))
    w_neg = float(ftrl_weights(jnp.array(1.0), jnp.array(-5.0), P))
    assert w_pos < 0 < w_neg
    assert w_pos == pytest.approx(-w_neg)


def test_accumulate_formula():
    n, z, w = jnp.array(4.0), jnp.array(2.0), jnp.array(0.5)
    g, g2 = jnp.array(3.0), jnp.array(9.0)
    nn, nz = ftrl_accumulate(n, z, w, g, g2, P)
    sigma = (np.sqrt(13.0) - 2.0) / P.alpha
    assert float(nn) == pytest.approx(13.0)
    assert float(nz) == pytest.approx(2.0 + 3.0 - sigma * 0.5, rel=1e-6)


def test_dense_update_matches_sequential_aggregation():
    """Duplicate ids in one batch: g and g^2 summed, one closed-form step."""
    r = 6
    rng_w = np.random.default_rng(3)
    n_tab = jnp.asarray(np.random.default_rng(1).random(r).astype(np.float32))
    z_tab = jnp.asarray(np.random.default_rng(2).standard_normal(r).astype(np.float32))
    w_tab = jnp.asarray(
        closed_form(np.asarray(n_tab), np.asarray(z_tab), P.alpha, P.beta, P.l1, P.l2)
    )
    ids = jnp.array([3, 1, 3, 3, 5, 1, r], dtype=jnp.int32)  # r = sentinel
    g = jnp.array([0.1, -0.2, 0.3, 0.4, 1.0, 0.5, 99.0], dtype=jnp.float32)
    g2 = g * g

    new_n, new_z, new_w = dense_ftrl_update(n_tab, z_tab, w_tab, ids, g, g2, P)

    n_np = np.asarray(n_tab).copy()
    z_np = np.asarray(z_tab).copy()
    for uid in (1, 3, 5):
        m = np.asarray(ids)[:-1] == uid
        sg = float(np.asarray(g)[:-1][m].sum())
        sg2 = float(np.asarray(g2)[:-1][m].sum())
        w = closed_form(n_np[uid], z_np[uid], P.alpha, P.beta, P.l1, P.l2)
        sigma = (np.sqrt(n_np[uid] + sg2) - np.sqrt(n_np[uid])) / P.alpha
        z_np[uid] += sg - sigma * w
        n_np[uid] += sg2

    np.testing.assert_allclose(np.asarray(new_n), n_np, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(new_z), z_np, rtol=1e-5)
    # w refreshed from the updated accumulators wherever n > 0
    expect_w = closed_form(n_np, z_np, P.alpha, P.beta, P.l1, P.l2)
    touched = n_np > 0
    np.testing.assert_allclose(
        np.asarray(new_w)[touched], expect_w[touched], rtol=1e-5
    )


def test_dense_update_sentinel_dropped():
    n_tab = jnp.zeros(4)
    z_tab = jnp.zeros(4)
    w_tab = jnp.zeros(4)
    ids = jnp.full((8,), 4, dtype=jnp.int32)  # all padding
    g = jnp.ones(8)
    new_n, new_z, new_w = dense_ftrl_update(n_tab, z_tab, w_tab, ids, g, g * g, P)
    assert float(jnp.abs(new_n).sum()) == 0.0
    assert float(jnp.abs(new_z).sum()) == 0.0
    assert float(jnp.abs(new_w).sum()) == 0.0


def test_dense_update_vector_rows_and_keep_init():
    r, d = 5, 3
    n_tab = jnp.zeros((r, d))
    z_tab = jnp.zeros((r, d))
    w_tab = jnp.full((r, d), 0.07, jnp.float32)  # "random init"
    ids = jnp.array([2, 2, 0], dtype=jnp.int32)
    g = jnp.arange(9, dtype=jnp.float32).reshape(3, d)
    new_n, new_z, new_w = dense_ftrl_update(n_tab, z_tab, w_tab, ids, g, g * g, P)
    np.testing.assert_allclose(np.asarray(new_n)[2], [9.0, 17.0, 29.0])  # 0+9, 1+16, 4+25
    np.testing.assert_allclose(np.asarray(new_n)[0], [36.0, 49.0, 64.0])
    assert np.asarray(new_n)[1].sum() == 0
    # untouched row keeps its init weight ("keep_init" lazy-materialization)
    np.testing.assert_allclose(np.asarray(new_w)[1], 0.07)
    # touched rows switch to the closed form
    expect = closed_form(
        np.asarray(new_n)[2], np.asarray(new_z)[2], P.alpha, P.beta, P.l1, P.l2
    )
    np.testing.assert_allclose(np.asarray(new_w)[2], expect, rtol=1e-6)
    # g[0] row 2 component 0 is 0 -> but row still touched via other comps
    assert np.asarray(new_n)[2].min() >= 0


def test_keep_init_is_dust_proof():
    """The untouched-row test must not flip on cancellation dust: the FFM
    self-slot gradient is a subtractive cancellation (ops/interactions.py:
    t - oh_e * xv) whose O(ulp) residue (~1e-11 in g) varies with XLA fusion
    choices.  A slot whose only "touches" are dust must keep its init weight
    — exactly like a slot the compilation cancelled to exact zero — or two
    runs of identical math diverge at init scale (see ftrl.UNTOUCHED_N)."""
    r, d = 3, 2
    init = jnp.full((r, d), 0.07, jnp.float32)
    ids = jnp.array([0, 1], dtype=jnp.int32)
    # row 0: cancellation dust; row 1: a real (small) first touch
    g = jnp.array([[1e-11, -3e-11], [1e-3, 2e-3]], jnp.float32)
    new_n, new_z, new_w = dense_ftrl_update(
        jnp.zeros((r, d)), jnp.zeros((r, d)), init, ids, g, g * g, P
    )
    assert float(np.asarray(new_n)[0].max()) < UNTOUCHED_N  # dust stays dust
    np.testing.assert_allclose(np.asarray(new_w)[0], 0.07)  # init kept
    np.testing.assert_allclose(np.asarray(new_w)[2], 0.07)  # untouched kept
    expect = closed_form(
        np.asarray(new_n)[1], np.asarray(new_z)[1], P.alpha, P.beta, P.l1, P.l2
    )
    np.testing.assert_allclose(np.asarray(new_w)[1], expect, rtol=1e-6)


def test_bias_update():
    g = jnp.array([0.5, -0.25, 0.0])
    bn, bz = bias_update(jnp.array(0.0), jnp.array(0.0), g, P)
    assert float(bn) == pytest.approx(0.3125)
    assert float(bz) == pytest.approx(0.25)  # w=0 -> z += sum_g


def test_sparse_update_matches_dense():
    """sparse (sort/segment/scatter) path == dense accumulator path."""
    from ftrl_ffm_tpu.ftrl import dense_ftrl_update, sparse_ftrl_update

    rng = np.random.default_rng(5)
    r, d, n = 50, 6, 40
    n_np = rng.random((r, d)).astype(np.float32)
    z_np = rng.standard_normal((r, d)).astype(np.float32)
    n_tab = jnp.asarray(n_np)
    z_tab = jnp.asarray(z_np)
    # w must satisfy the state invariant w = f(n, z) on touched rows (the
    # dense path re-derives w for every ever-touched row; the sparse path
    # only rewrites rows in the batch — identical only under the invariant)
    w_tab = jnp.asarray(closed_form(n_np, z_np, P.alpha, P.beta, P.l1, P.l2))
    ids = jnp.asarray(
        np.concatenate([rng.integers(0, r, n - 5), np.full(5, r)]).astype(np.int32)
    )  # includes sentinel padding
    g = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    g2 = g * g

    dn, dz, dw = dense_ftrl_update(n_tab, z_tab, w_tab, ids, g, g2, P)
    sn, sz, sw = sparse_ftrl_update(n_tab, z_tab, w_tab, ids, g, g2, P)
    np.testing.assert_allclose(np.asarray(sn), np.asarray(dn), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(sz), np.asarray(dz), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sw), np.asarray(dw), rtol=1e-5, atol=1e-7)


def test_sparse_update_scalar_table():
    from ftrl_ffm_tpu.ftrl import dense_ftrl_update, sparse_ftrl_update

    rng = np.random.default_rng(6)
    r, n = 30, 64
    n_tab = jnp.zeros((r,)); z_tab = jnp.zeros((r,)); w_tab = jnp.zeros((r,))
    ids = jnp.asarray(rng.integers(0, r, n).astype(np.int32))
    g = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    dn, dz, dw = dense_ftrl_update(n_tab, z_tab, w_tab, ids, g, g * g, P)
    sn, sz, sw = sparse_ftrl_update(n_tab, z_tab, w_tab, ids, g, g * g, P)
    np.testing.assert_allclose(np.asarray(sn), np.asarray(dn), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(sz), np.asarray(dz), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sw), np.asarray(dw), rtol=1e-5, atol=1e-8)


def test_select_ftrl_update_heuristic():
    from ftrl_ffm_tpu.ftrl import (
        dense_ftrl_update,
        select_ftrl_update,
        sparse_ftrl_update,
    )

    assert select_ftrl_update(100_000, 624, 319_488) is dense_ftrl_update
    assert select_ftrl_update(10_000_000, 624, 319_488) is sparse_ftrl_update
    assert select_ftrl_update(1_000_000, 624, 319_488) is sparse_ftrl_update  # temp>2GB


def test_combined_payload_updates_match_split():
    """dense_ftrl_update2 / sparse_ftrl_update2 (single combined (g||g^2)
    scatter payload, the fused-kernel hot path) == the split-form oracle updates."""
    import jax.numpy as jnp

    from ftrl_ffm_tpu.ftrl import (
        dense_ftrl_update,
        dense_ftrl_update2,
        sparse_ftrl_update,
        sparse_ftrl_update2,
    )

    rng = np.random.default_rng(11)
    R, D, N = 37, 6, 50
    n_tab = jnp.asarray(np.abs(rng.normal(size=(R, D))).astype(np.float32))
    z_tab = jnp.asarray(rng.normal(size=(R, D)).astype(np.float32))
    w_tab = jnp.asarray(rng.normal(size=(R, D)).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, R + 3, N).astype(np.int32))  # some dropped
    g = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    gg2 = jnp.concatenate([g, g * g], axis=-1)

    for split, combined in (
        (dense_ftrl_update, dense_ftrl_update2),
        (sparse_ftrl_update, sparse_ftrl_update2),
    ):
        en, ez, ew = split(n_tab, z_tab, w_tab, ids, g, g * g, P)
        cn, cz, cw = combined(n_tab, z_tab, w_tab, ids, gg2, P)
        np.testing.assert_allclose(np.asarray(cn), np.asarray(en), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(cz), np.asarray(ez), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(cw), np.asarray(ew), rtol=1e-5, atol=1e-7)

    # 1-D (linear-table) form: payload [N, 2]
    lin_n = jnp.asarray(np.abs(rng.normal(size=R)).astype(np.float32))
    lin_z = jnp.asarray(rng.normal(size=R).astype(np.float32))
    lin_w = jnp.asarray(rng.normal(size=R).astype(np.float32))
    gl = jnp.asarray(rng.normal(size=N).astype(np.float32))
    ggl = jnp.stack([gl, gl * gl], axis=-1)
    en, ez, ew = dense_ftrl_update(lin_n, lin_z, lin_w, ids, gl, gl * gl, P)
    cn, cz, cw = dense_ftrl_update2(lin_n, lin_z, lin_w, ids, ggl, P)
    np.testing.assert_allclose(np.asarray(cz), np.asarray(ez), rtol=1e-5, atol=1e-6)
    en, ez, ew = sparse_ftrl_update(lin_n, lin_z, lin_w, ids, gl, gl * gl, P)
    cn, cz, cw = sparse_ftrl_update2(lin_n, lin_z, lin_w, ids, ggl, P)
    np.testing.assert_allclose(np.asarray(cz), np.asarray(ez), rtol=1e-5, atol=1e-6)


def test_inplace_update_matches_dense2():
    """dense_ftrl_update_inplace (huge-table path: g scattered straight into
    z, single g^2 accumulator) == the combined dense oracle."""
    import jax.numpy as jnp

    from ftrl_ffm_tpu.ftrl import dense_ftrl_update2, dense_ftrl_update_inplace

    rng = np.random.default_rng(12)
    R, D, N = 41, 6, 64
    n_tab = jnp.asarray(np.abs(rng.normal(size=(R, D))).astype(np.float32))
    z_tab = jnp.asarray(rng.normal(size=(R, D)).astype(np.float32))
    w_tab = jnp.asarray(rng.normal(size=(R, D)).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, R + 3, N).astype(np.int32))
    g = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    gg2 = jnp.concatenate([g, g * g], axis=-1)

    en, ez, ew = dense_ftrl_update2(n_tab, z_tab, w_tab, ids, gg2, P)
    cn, cz, cw = dense_ftrl_update_inplace(n_tab, z_tab, w_tab, ids, g, g * g, P)
    np.testing.assert_allclose(np.asarray(cn), np.asarray(en), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(cz), np.asarray(ez), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(cw), np.asarray(ew), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shape", [(41, 6), (7, 640), (1, 3)])
def test_inplace_update_whole_table_pass(shape):
    """The in-place update's single whole-table closed-form pass: any row
    count (no block decomposition to divide it), bit-deterministic across
    calls, and identical to the dense combined oracle."""
    import jax.numpy as jnp

    from ftrl_ffm_tpu.ftrl import dense_ftrl_update2, dense_ftrl_update_inplace

    rng = np.random.default_rng(13)
    R, D = shape
    N = 64
    n_tab = jnp.asarray(np.abs(rng.normal(size=(R, D))).astype(np.float32))
    z_tab = jnp.asarray(rng.normal(size=(R, D)).astype(np.float32))
    w_tab = jnp.asarray(rng.normal(size=(R, D)).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, R + 3, N).astype(np.int32))
    g = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))

    out = dense_ftrl_update_inplace(n_tab, z_tab, w_tab, ids, g, g * g, P)
    again = dense_ftrl_update_inplace(n_tab, z_tab, w_tab, ids, g, g * g, P)
    for got, want in zip(again, out):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    ref = dense_ftrl_update2(
        n_tab, z_tab, w_tab, ids, jnp.concatenate([g, g * g], axis=-1), P
    )
    for got, want in zip(out, ref):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6
        )


def test_select_update_kind_thresholds():
    from ftrl_ffm_tpu.ftrl import select_update_kind

    nnz = 319_488  # B=8192 * F=39
    # headline config: dense combined accumulators
    assert select_update_kind(100_000, 624, nnz) == "dense2"
    # 1M-row flagship huge-table config: in-place (one 2.5 GB accumulator)
    assert select_update_kind(1_000_000, 624, nnz) == "inplace"
    # beyond-HBM tables: sort/segment sparse
    assert select_update_kind(10_000_000, 624, nnz) == "sparse2"
    # linear (1-D) tables never need the in-place form
    assert select_update_kind(1_000_000, 0, nnz) == "dense2"
    # explicit modes are respected
    assert select_update_kind(100_000, 624, nnz, "sparse") == "sparse2"
    assert select_update_kind(10_000_000, 624, nnz, "dense") == "dense2"


def test_train_step_inplace_path_matches_dense(tmp_path):
    """A model forced onto the in-place path (big table) must produce the
    same step as the dense path on the same data."""
    import jax.numpy as jnp

    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.models import Batch, make_model

    rng = np.random.default_rng(5)
    arrays = (
        rng.integers(0, 4, (16, 5)).astype(np.int32),
        rng.integers(0, 50, (16, 5)).astype(np.int32),
        rng.random((16, 5)).astype(np.float32),
        (rng.random(16) > 0.5).astype(np.float32),
        np.ones(16, np.float32),
    )
    batch = Batch(*(jnp.asarray(a) for a in arrays))
    kw = dict(model_type="FFM", n_feats=50, n_fields=4, n_factors=4,
              batch_size=16, max_nnz=5)
    m_dense = make_model(Config(**kw, update_mode="dense"))
    out_d = m_dense.train_step(m_dense.init(), batch)

    import ftrl_ffm_tpu.models.base as mb
    orig = mb.select_update_kind
    mb.select_update_kind = lambda r, d, n, mode="auto": (
        "inplace" if d else orig(r, d, n, mode)
    )
    try:
        m_ip = make_model(Config(**kw))
        out_i = m_ip.train_step(m_ip.init(), batch)
    finally:
        mb.select_update_kind = orig
    np.testing.assert_allclose(
        np.asarray(out_i.state.vec_z), np.asarray(out_d.state.vec_z),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(out_i.logits), np.asarray(out_d.logits), rtol=1e-5, atol=1e-6
    )
