"""Fused FFM kernels and the in-place update compiled for the GPU (no
interpret mode).

Marked `gpu`: they skip on the CPU and run on the card through
chip_smoke.py.  The flagship comparison at B=2048 is chip_smoke.py's own
kernel phase; these cover the wrapper's other shapes and outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ftrl_ffm_tpu.ops.ffm_pallas import ffm_fused_logits, ffm_fused_logits_grads
from ftrl_ffm_tpu.ops.interactions import ffm_logits_and_grads


def _inputs(b, f, c, k, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(b, f, c * k)).astype(np.float32) * 0.1
    fields = rng.integers(0, c - 1, (b, f)).astype(np.int32)
    vals = rng.random((b, f)).astype(np.float32)
    lin = rng.normal(size=(b,)).astype(np.float32) * 0.1
    y = (rng.random(b) > 0.5).astype(np.float32)
    sw = (rng.random(b) > 0.2).astype(np.float32)
    return tuple(jnp.asarray(a) for a in (v, fields, vals, lin, y, sw))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1000, 17])
def test_ragged_batch_on_gpu(b):
    """Batch sizes with no power-of-two factor: masks, not block shapes,
    bound every program."""
    f, c, k = 39, 40, 16
    v, fields, vals, lin, y, sw = _inputs(b, f, c, k)
    ref, dv = ffm_logits_and_grads(v, fields, vals, lin, c, k, True, grad_lane=39)
    g_ref = ((jax.nn.sigmoid(ref) - y) * sw)[:, None, None] * dv
    logits, gg2 = ffm_fused_logits_grads(
        v.reshape(b * f, -1), fields, vals, lin, y, sw, c, k, aug_lane=39
    )
    np.testing.assert_allclose(logits, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        gg2[:, : c * k], g_ref.reshape(b * f, -1), rtol=1e-4, atol=1e-6
    )


@pytest.mark.gpu
def test_split_bf16_payload_on_gpu():
    """combined_out=False with a bf16 payload: the in-place update's two
    outputs, rounded once from the f32 gradient."""
    b, f, c, k = 256, 39, 40, 16
    v, fields, vals, lin, y, sw = _inputs(b, f, c, k, seed=1)
    args = (v.reshape(b * f, -1), fields, vals, lin, y, sw, c, k)
    _, gg2 = ffm_fused_logits_grads(*args, aug_lane=39)
    _, g, g2 = ffm_fused_logits_grads(
        *args, aug_lane=39, combined_out=False, out_dtype=jnp.bfloat16
    )
    e = c * k
    assert g.dtype == g2.dtype == jnp.bfloat16
    # one rounding to bf16's 8-bit mantissa: within half an ulp (2^-8
    # relative) of the f32 payload, up to the f32 payload's own last bits
    for got, want in ((g, gg2[:, :e]), (g2, gg2[:, e:])):
        np.testing.assert_allclose(
            np.asarray(got, np.float32), want, rtol=2.0**-8 + 1e-5, atol=1e-12
        )


@pytest.mark.gpu
def test_inference_kernel_on_gpu():
    b, f, c, k = 512, 39, 40, 16
    v, fields, vals, lin, _, _ = _inputs(b, f, c, k, seed=2)
    ref, _ = ffm_logits_and_grads(v, fields, vals, lin, c, k, False)
    got = ffm_fused_logits(v.reshape(b * f, -1), fields, vals, lin, c, k)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_inplace_step_writes_tables_in_place_on_gpu():
    """The compiled train step of the in-place update carries no
    table-sized copy: the closed form writes n, z and w where they lie
    (ftrl.py::scatter_sum keeps XLA from copying a table around it)."""
    import re

    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.models import Batch
    from ftrl_ffm_tpu.train import Trainer

    r, f, b = 20_000, 39, 1024
    cfg = Config(model_type="FFM", n_fields=f, n_factors=16, n_feats=r,
                 batch_size=b, max_nnz=f, file_type="libffm",
                 update_mode="inplace")
    tr = Trainer(cfg)
    rng = np.random.default_rng(0)
    batch = Batch(
        fields=jnp.asarray(np.tile(np.arange(f, dtype=np.int32), (b, 1))),
        feats=jnp.asarray(rng.integers(0, r, (b, f)).astype(np.int32)),
        vals=jnp.ones((b, f), jnp.float32),
        y=jnp.asarray((rng.random(b) > 0.75).astype(np.float32)),
        sample_w=jnp.ones((b,), jnp.float32),
    )
    hlo = tr._train_step.lower(tr.state, batch).compile().as_text()
    copies = re.findall(rf"f32\[{r},{cfg.row_width}\]\S* copy\(", hlo)
    assert not copies, copies
