"""Fused FFM kernels (Pallas, Triton route) == the XLA formulation, run in
interpret mode on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ftrl_ffm_tpu.ops.ffm_pallas import ffm_fused_logits_grads
from ftrl_ffm_tpu.ops.interactions import ffm_logits_and_grads


@pytest.mark.parametrize("b,f,c,k", [(16, 5, 4, 8), (32, 39, 39, 16)])
def test_fused_kernel_matches_xla(b, f, c, k):
    rng = np.random.default_rng(0)
    e = c * k
    v = jnp.asarray(rng.normal(size=(b, f, e)).astype(np.float32) * 0.1)
    fields = jnp.asarray(rng.integers(0, c, (b, f)).astype(np.int32))
    vals = jnp.asarray(rng.random((b, f)).astype(np.float32))
    lin = jnp.asarray(rng.normal(size=(b,)).astype(np.float32) * 0.1)
    y = jnp.asarray((rng.random(b) > 0.5).astype(np.float32))
    sw = jnp.asarray((rng.random(b) > 0.2).astype(np.float32))  # some padded

    logits_ref, dv = ffm_logits_and_grads(v, fields, vals, lin, c, k, True)
    gs = (jax.nn.sigmoid(logits_ref) - y) * sw
    g_ref = gs[:, None, None] * dv

    logits, gg2 = ffm_fused_logits_grads(
        v.reshape(b * f, e), fields, vals, lin, y, sw, c, k,
        interpret=True,
    )
    g = gg2[:, :e].reshape(b, f, e)
    g2 = gg2[:, e:].reshape(b, f, e)
    np.testing.assert_allclose(
        np.asarray(logits), np.asarray(logits_ref), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(g), np.asarray(g_ref), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(g2), np.asarray(g) ** 2, rtol=1e-6, atol=1e-9
    )


def test_fused_kernel_padding_inert():
    """Padded occurrences (val 0) and padded samples (sw 0) give zero grads."""
    b, f, c, k = 8, 4, 3, 4
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.normal(size=(b, f, c * k)).astype(np.float32))
    fields = jnp.zeros((b, f), jnp.int32)
    vals = jnp.zeros((b, f), jnp.float32)  # all padding occurrences
    lin = jnp.zeros((b,), jnp.float32)
    y = jnp.ones((b,), jnp.float32)
    sw = jnp.zeros((b,), jnp.float32)      # all samples padded
    logits, gg2 = ffm_fused_logits_grads(
        v.reshape(b, -1).reshape(b * f, c * k), fields, vals, lin, y, sw, c, k,
        interpret=True,
    )
    assert float(jnp.abs(gg2).sum()) == 0.0
    np.testing.assert_allclose(np.asarray(logits), 0.0, atol=1e-7)


def test_inference_kernel_matches_xla():
    from ftrl_ffm_tpu.ops.ffm_pallas import ffm_fused_logits

    b, f, c, k = 16, 5, 4, 8
    rng = np.random.default_rng(4)
    e = c * k
    v = jnp.asarray(rng.normal(size=(b, f, e)).astype(np.float32) * 0.1)
    fields = jnp.asarray(rng.integers(0, c, (b, f)).astype(np.int32))
    vals = jnp.asarray(rng.random((b, f)).astype(np.float32))
    lin = jnp.asarray(rng.normal(size=(b,)).astype(np.float32) * 0.1)
    ref, _ = ffm_logits_and_grads(v, fields, vals, lin, c, k, False)
    got = ffm_fused_logits(
        v.reshape(b * f, e), fields, vals, lin, c, k, interpret=True
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_fused_kernel_bf16_payload_close_to_f32():
    """acc_dtype=bfloat16: payload emitted bf16 tracks the f32 payload to
    bf16 precision (and g2 stays the square of g up to rounding)."""
    rng = np.random.default_rng(3)
    b, f, c, k = 16, 5, 4, 8
    e = c * k
    v = jnp.asarray(rng.normal(size=(b, f, e)).astype(np.float32) * 0.1)
    fields = jnp.asarray(rng.integers(0, c, (b, f)).astype(np.int32))
    vals = jnp.asarray(rng.random((b, f)).astype(np.float32))
    lin = jnp.asarray(rng.normal(size=(b,)).astype(np.float32) * 0.1)
    y = jnp.asarray((rng.random(b) > 0.5).astype(np.float32))
    sw = jnp.ones((b,), jnp.float32)

    common = dict(interpret=True)
    logits32, gg2_32 = ffm_fused_logits_grads(
        v.reshape(b * f, e), fields, vals, lin, y, sw, c, k, **common
    )
    logits16, gg2_16 = ffm_fused_logits_grads(
        v.reshape(b * f, e), fields, vals, lin, y, sw, c, k,
        out_dtype=jnp.bfloat16, **common
    )
    assert gg2_16.dtype == jnp.bfloat16
    # logits are unaffected by the payload dtype
    np.testing.assert_allclose(
        np.asarray(logits16), np.asarray(logits32), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(gg2_16, np.float32), np.asarray(gg2_32),
        rtol=1e-2, atol=1e-3,
    )


def test_dense_update2_bf16_payload_close_to_f32():
    """FTRL tables stay f32 and track the f32 update to bf16 payload
    precision when the combined payload is bf16 (Config.acc_dtype)."""
    from ftrl_ffm_tpu.ftrl import FtrlParams, dense_ftrl_update2

    rng = np.random.default_rng(4)
    r, d, n = 32, 8, 64
    n_tab = jnp.asarray(rng.random((r, d)).astype(np.float32))
    z_tab = jnp.asarray(rng.normal(size=(r, d)).astype(np.float32))
    p = FtrlParams()
    w_tab = jnp.zeros((r, d), jnp.float32)
    ids = jnp.asarray(rng.integers(0, r + 1, (n,)).astype(np.int32))  # incl. sentinel
    g = rng.normal(size=(n, d)).astype(np.float32) * 0.1
    gg2 = jnp.asarray(np.concatenate([g, g * g], axis=-1))

    out32 = dense_ftrl_update2(n_tab, z_tab, w_tab, ids, gg2, p)
    out16 = dense_ftrl_update2(
        n_tab, z_tab, w_tab, ids, gg2.astype(jnp.bfloat16), p
    )
    for a32, a16 in zip(out32, out16):
        assert a16.dtype == jnp.float32
        np.testing.assert_allclose(
            np.asarray(a16), np.asarray(a32), rtol=2e-2, atol=2e-2
        )


def test_fused_kernel_aug_lane_payload():
    """aug_lane: dead lane (k=0, c=n_real_fields) of the combined payload
    carries g_lin = gs * x (+ its square at D + lane); every other lane
    matches the non-augmented payload bit-for-bit (a dead lane's factor
    grad is always zero, so the lane select changes nothing else)."""
    rng = np.random.default_rng(5)
    b, f, c_real, k = 16, 5, 4, 8
    c = c_real + 1  # padded field count: field 4 never occurs
    e = c * k
    v = jnp.asarray(rng.normal(size=(b, f, e)).astype(np.float32) * 0.1)
    fields = jnp.asarray(rng.integers(0, c_real, (b, f)).astype(np.int32))
    vals = jnp.asarray(rng.random((b, f)).astype(np.float32))
    lin = jnp.asarray(rng.normal(size=(b,)).astype(np.float32) * 0.1)
    y = jnp.asarray((rng.random(b) > 0.5).astype(np.float32))
    sw = jnp.asarray((rng.random(b) > 0.2).astype(np.float32))

    common = dict(interpret=True)
    logits0, gg2 = ffm_fused_logits_grads(
        v.reshape(b * f, e), fields, vals, lin, y, sw, c, k, **common
    )
    logits1, gg2a = ffm_fused_logits_grads(
        v.reshape(b * f, e), fields, vals, lin, y, sw, c, k,
        aug_lane=c_real, **common
    )
    assert gg2a.shape == gg2.shape == (b * f, 2 * e)
    np.testing.assert_allclose(np.asarray(logits1), np.asarray(logits0), rtol=1e-6)
    keep = np.ones(2 * e, bool)
    keep[[c_real, e + c_real]] = False
    np.testing.assert_allclose(
        # the added lane-select shifts fusion order by ~1 ulp elsewhere
        np.asarray(gg2a)[:, keep], np.asarray(gg2)[:, keep],
        rtol=1e-5, atol=1e-8,
    )
    # the dead lane held zeros without aug...
    np.testing.assert_array_equal(np.asarray(gg2)[:, c_real], 0.0)
    # ...and carries the linear grad + square with aug
    gs = (jax.nn.sigmoid(np.asarray(logits0)) - np.asarray(y)) * np.asarray(sw)
    g_lin = (gs[:, None] * np.asarray(vals)).reshape(-1)
    np.testing.assert_allclose(
        np.asarray(gg2a[:, c_real]), g_lin, rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(gg2a[:, e + c_real]), g_lin * g_lin, rtol=1e-5, atol=1e-9
    )


def test_dense_update2_aug_matches_separate_updates():
    """One dead-lane augmented scatter == the separate vec + lin dense
    updates (on every lane except the dead one, which shadows the linear
    stats and is never read)."""
    from ftrl_ffm_tpu.ftrl import (
        FtrlParams, dense_ftrl_update2, dense_ftrl_update2_aug,
    )

    rng = np.random.default_rng(6)
    r, d, n, lane = 40, 8, 96, 5
    p = FtrlParams()
    vec_n = jnp.asarray(rng.random((r, d)).astype(np.float32))
    vec_z = jnp.asarray(rng.normal(size=(r, d)).astype(np.float32))
    vec_w = jnp.asarray(rng.normal(size=(r, d)).astype(np.float32) * 0.01)
    lin_n = jnp.asarray(rng.random((r,)).astype(np.float32))
    lin_z = jnp.asarray(rng.normal(size=(r,)).astype(np.float32))
    lin_w = jnp.asarray(rng.normal(size=(r,)).astype(np.float32) * 0.01)
    ids = jnp.asarray(rng.integers(0, r + 1, (n,)).astype(np.int32))
    g = rng.normal(size=(n, d)).astype(np.float32) * 0.1
    g[:, lane] = 0.0  # the dead lane never carries a factor grad
    gl = rng.normal(size=(n,)).astype(np.float32) * 0.1

    gg2_vec = jnp.asarray(np.concatenate([g, g * g], axis=-1))
    gg2_lin = jnp.asarray(np.stack([gl, gl * gl], axis=-1))
    ga = g.copy()
    ga[:, lane] = gl  # linear grad rides in the dead lane
    gg2a = jnp.asarray(np.concatenate([ga, ga * ga], axis=-1))

    vec_ref = dense_ftrl_update2(vec_n, vec_z, vec_w, ids, gg2_vec, p)
    lin_ref = dense_ftrl_update2(lin_n, lin_z, lin_w, ids, gg2_lin, p)
    (vn, vz, vw), (ln, lz, lw) = dense_ftrl_update2_aug(
        vec_n, vec_z, vec_w, lin_n, lin_z, lin_w, ids, gg2a, lane, p
    )
    cols = [c for c in range(d) if c != lane]
    for got, want in zip((vn, vz, vw), vec_ref):
        np.testing.assert_allclose(
            np.asarray(got)[:, cols], np.asarray(want)[:, cols], rtol=1e-6
        )
    for got, want in zip((ln, lz, lw), lin_ref):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_train_step_pallas_aug_matches_xla(monkeypatch):
    """Full train_step through the fused aug path (interpret mode) ==
    the pure-XLA path, several chained steps."""
    from tests.common import interpret_kernels
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.models import Batch, make_model

    interpret_kernels(monkeypatch)

    rng = np.random.default_rng(7)
    b, c, k, r, f = 16, 4, 8, 64, 4
    kw = dict(
        model_type="FFM", n_fields=c, n_feats=r, n_factors=k,
        batch_size=b, max_nnz=f,
        # keep_init random factors amplify kernel-vs-XLA ulp noise in g by
        # sigma ~ dg/alpha = 1e4 * dg against the init w; reference
        # semantics (w init 0) keeps the trajectories comparable
        factor_semantics="reference",
    )
    cfg_p = Config(use_pallas="on", **kw)
    cfg_x = Config(use_pallas="off", **kw)
    m_p, m_x = make_model(cfg_p), make_model(cfg_x)
    st_p, st_x = m_p.init(), m_x.init()
    for i in range(3):
        batch = Batch(
            fields=jnp.asarray(rng.integers(0, c, (b, f)).astype(np.int32)),
            feats=jnp.asarray(rng.integers(0, r, (b, f)).astype(np.int32)),
            vals=jnp.asarray(rng.random((b, f)).astype(np.float32)),
            y=jnp.asarray((rng.random(b) > 0.5).astype(np.float32)),
            sample_w=jnp.asarray(np.ones(b, np.float32)),
        )
        out_p = m_p.train_step(st_p, batch)
        out_x = m_x.train_step(st_x, batch)
        st_p, st_x = out_p.state, out_x.state
        np.testing.assert_allclose(
            # kernel-vs-XLA contraction order: ~1 ulp per product, summed
            float(out_p.loss_sum), float(out_x.loss_sum), rtol=3e-4
        )
    np.testing.assert_allclose(
        # chained-step trajectories: kernel-vs-XLA ulp noise compounds
        # through the FTRL closed form's |z| <= l1 threshold
        np.asarray(st_p.lin_z), np.asarray(st_x.lin_z), rtol=2e-3, atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(st_p.vec_z), np.asarray(st_x.vec_z), rtol=2e-3, atol=5e-5
    )


def test_closed_form_pass_matches_dense_update():
    """ftrl.py::closed_form_pass (the in-place update's whole-table XLA
    fusion) on z' = z + sum_g and A = sum_g2 == the two-accumulator dense
    update, and leaves untouched rows bit-exact."""
    from ftrl_ffm_tpu.ftrl import FtrlParams, closed_form_pass, dense_ftrl_update

    rng = np.random.default_rng(3)
    r, d, nnz = 64, 128, 96
    p = FtrlParams(alpha=0.05, beta=1.0, l1=0.1, l2=1.0)
    n = jnp.asarray(np.abs(rng.normal(0, 1, (r, d))).astype(np.float32))
    n = n.at[:8].set(0.0)  # never-touched rows
    z = jnp.asarray(rng.normal(0, 1, (r, d)).astype(np.float32))
    w = jnp.asarray(rng.normal(0, 0.1, (r, d)).astype(np.float32))
    ids = jnp.asarray(rng.integers(8, r + 1, nnz).astype(np.int32))  # incl. drop
    g = jnp.asarray(rng.normal(0, 1, (nnz, d)).astype(np.float32))
    g2 = g * g

    ref = dense_ftrl_update(n, z, w, ids, g, g2, p)
    zp = z.at[ids].add(g, mode="drop")
    a = jnp.zeros_like(n).at[ids].add(g2, mode="drop")
    got = closed_form_pass(n, zp, w, a, p)
    for name, x, y in zip(("n", "z", "w"), got, ref):
        np.testing.assert_allclose(
            np.asarray(x), np.asarray(y), rtol=1e-6, atol=1e-6,
            err_msg=f"closed-form pass mismatch in {name}",
        )
    for x, y in zip(got, (n, z, w)):
        np.testing.assert_array_equal(np.asarray(x)[:8], np.asarray(y)[:8])


@pytest.mark.parametrize("shape", [(64, 128), (33, 640), (5000,)])
def test_scatter_sum_matches_plain_scatter(shape):
    """ftrl.py::scatter_sum (the in-place update's accumulator, behind its
    barriers) == a plain scatter-add into zeros, dropping ids past the
    end, for 2-D tables and a 1-D one."""
    from ftrl_ffm_tpu.ftrl import scatter_sum

    rng = np.random.default_rng(3)
    r = shape[0]
    ids = jnp.asarray(rng.integers(0, r + 1, 3 * r).astype(np.int32))  # incl. drop
    upd = jnp.asarray(rng.normal(0, 1, (3 * r,) + shape[1:]).astype(np.float32))
    want = np.zeros(shape, np.float32)
    keep = np.asarray(ids) < r
    np.add.at(want, np.asarray(ids)[keep], np.asarray(upd)[keep])
    got = jax.jit(scatter_sum, static_argnums=0)(shape, ids, upd)
    assert got.shape == shape and got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


def test_inplace_update_lowers_past_int32_elements():
    """A table past 2^31 elements (3.4M rows x 640, the per-card shard of a
    sharded 16M-row model) traces and lowers: no index math of the in-place
    update is int32-bound.  Lowering only; nothing is allocated."""
    from ftrl_ffm_tpu.ftrl import FtrlParams, dense_ftrl_update_inplace

    r, d, nnz = 3_400_000, 640, 1024
    assert r * d > 2**31
    tab = jax.ShapeDtypeStruct((r, d), jnp.float32)
    pay = jax.ShapeDtypeStruct((nnz, d), jnp.float32)
    ids = jax.ShapeDtypeStruct((nnz,), jnp.int32)
    f = jax.jit(dense_ftrl_update_inplace, static_argnums=6,
                donate_argnums=(0, 1, 2))
    lowered = f.lower(tab, tab, tab, ids, pay, pay, FtrlParams())
    outs = jax.tree.leaves(lowered.out_info)
    assert [o.shape for o in outs] == [(r, d)] * 3



@pytest.mark.parametrize(
    "b,f,c,k,aug",
    [
        (24, 3, 7, 16, 6),    # aug on the dead top field (fields < c-1)
        (8, 8, 8, 4, -1),     # F == C, tiny K
        (40, 6, 5, 32, -1),   # batch not a power of two, K=32
        (16, 10, 40, 16, 39), # flagship-like padded row, dead lane 39
    ],
)
def test_fused_kernel_shape_sweep(b, f, c, k, aug):
    """Kernel == XLA across block-heuristic edge shapes: odd batches,
    F != C, padded rows with the aug lane, wide K."""
    if aug >= c * k:
        aug = -1
    rng = np.random.default_rng(1)
    e = c * k
    v = jnp.asarray(rng.normal(size=(b, f, e)).astype(np.float32) * 0.1)
    # fields < c-1 so the aug lane (if any) is genuinely dead
    fmax = max(1, c - 1)
    fields = jnp.asarray(rng.integers(0, fmax, (b, f)).astype(np.int32))
    vals = jnp.asarray(rng.random((b, f)).astype(np.float32))
    lin = jnp.asarray(rng.normal(size=(b,)).astype(np.float32) * 0.1)
    y = jnp.asarray((rng.random(b) > 0.5).astype(np.float32))
    sw = jnp.ones((b,), jnp.float32)

    logits_ref, dv = ffm_logits_and_grads(
        v, fields, vals, lin, c, k, True, grad_lane=aug
    )
    gs = (jax.nn.sigmoid(logits_ref) - y) * sw
    g_ref = gs[:, None, None] * dv

    logits, gg2 = ffm_fused_logits_grads(
        v.reshape(b * f, e), fields, vals, lin, y, sw, c, k,
        interpret=True, aug_lane=aug,
    )
    g = gg2[:, :e].reshape(b, f, e)
    np.testing.assert_allclose(
        np.asarray(logits), np.asarray(logits_ref), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(g), np.asarray(g_ref), rtol=1e-4, atol=1e-6
    )
