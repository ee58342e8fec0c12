"""Fused FFM interaction kernels for the GPU (Pallas, Triton route).

The XLA formulation (ops/interactions.py::ffm_logits_and_grads) materializes
several [B, F, C*K] intermediates (s, s_t, t, the one-hot masks, dlogit_dv)
in device memory around its batched contractions.  These kernels keep all of
that on chip: one program owns one sample, reads its gathered factor rows
and writes its gradient payload, and nothing else leaves the SM.

Math (reference: src/model/ffm.cpp:57-70 logit, :107-123 grads).  Factor
rows are factor-major (slot (k, c) = k*C + c, see ops/layout.py).  Per
sample, per factor k, the pair tile

    W_k[m, n] = v[m, (k, field_n)]                 (gather, [F, F])

holds every term the FFM pair loop touches, so

    logit  = lin + 0.5 * sum_k sum_{m != n} x_m x_n W_k[m, n] W_k[n, m]
    g[m, (k, c)] = gs * x_m * sum_{n != m, field_n = c} x_n W_k[n, m]
                 = gs * x_m * (Z_k @ onehot)[m, c]
    Z_k[m, n]    = [m != n] * x_n * W_k[n, m]

with gs = (sigmoid(logit) - y) * sample_w.  This is the reference's own
pair sum: the self term that the XLA form subtracts after the fact is
simply never added.  The program makes two passes over k: the first gives
the logit (hence gs), the second rebuilds each W_k and writes the gradient.
F and C pad to power-of-two tiles (39 -> 64, 40 -> 64); masks keep the
padding out of every sum, store and load, so any batch size works.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=2)


def available() -> bool:
    """True when the kernels can run compiled: JAX's backend is a GPU."""
    return jax.default_backend() == "gpu"


def resolve_use_pallas(mode: str) -> bool:
    """Config.use_pallas -> does the step run the hand-written GPU kernels
    of this module?  "auto": on the GPU yes, elsewhere the
    XLA formulation; "on": yes, and without a GPU that is an error; "off":
    never."""
    if mode == "off":
        return False
    if available():
        return True
    if mode == "on":
        raise RuntimeError(
            "use_pallas='on' needs a GPU, but JAX's backend is "
            f"{jax.default_backend()!r}; use 'auto' or 'off'"
        )
    return False


def _tile(n: int) -> int:
    # Triton tiles are powers of two, and a dot operand dimension >= 16
    return max(16, pl.next_power_of_2(n))


def _sample(fields_ref, vals_ref, f: int):
    """Row ids, field ids, values and the validity mask of this program's
    sample, each [FP] (FP = padded occurrence count)."""
    b = pl.program_id(0)
    m = jnp.arange(_tile(f), dtype=jnp.int32)
    valid = m < f
    rows = b * f + m
    fields = plgpu.load(fields_ref.at[rows], mask=valid, other=0)
    x = plgpu.load(vals_ref.at[rows], mask=valid, other=0.0)
    return b, rows, fields, x, valid


def _pair_tile(v_ref, rows, fields, valid, kk, c: int):
    """W_k[m, n] = v[rows[m], kk*C + fields[n]] with padded entries 0."""
    fp = rows.shape[0]
    r = jnp.broadcast_to(rows[:, None], (fp, fp))
    col = jnp.broadcast_to((kk * c + fields)[None, :], (fp, fp))
    mask = valid[:, None] & valid[None, :]
    return plgpu.load(v_ref.at[r, col], mask=mask, other=0.0)


def _pair_logit(v_ref, rows, fields, x, valid, c: int, k: int):
    """0.5 * sum_k sum_{m != n} x_m x_n W_k[m, n] W_k[n, m]."""
    fp = rows.shape[0]

    def body(kk, acc):
        w = _pair_tile(v_ref, rows, fields, valid, kk, c)
        return acc + w * w.T

    acc = jax.lax.fori_loop(0, k, body, jnp.zeros((fp, fp), jnp.float32))
    m = jnp.arange(fp, dtype=jnp.int32)
    xx = jnp.where(m[:, None] != m[None, :], x[:, None] * x[None, :], 0.0)
    return 0.5 * jnp.sum(jnp.sum(acc * xx, axis=1), axis=0)


def _onehot_dot(z, onehot):
    """z @ onehot in full f32 on the tensor cores.

    onehot is exactly 0/1 in bf16, and three bf16 pieces hold all 24 bits
    of z's mantissa, so every product is exact; only the f32 sum over
    occurrences of one field rounds, as it does in any f32 dot."""
    oh = onehot.astype(jnp.bfloat16)
    hi = z.astype(jnp.bfloat16)
    r = z - hi.astype(jnp.float32)
    mid = r.astype(jnp.bfloat16)
    lo = (r - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    return pl.dot(lo, oh) + pl.dot(mid, oh) + pl.dot(hi, oh)


def _train_kernel(
    fields_ref,  # [B*F] int32
    vals_ref,    # [B*F] f32
    lin_ref,     # [B] f32 (bias + linear logits)
    y_ref,       # [B] f32
    sw_ref,      # [B] f32
    v_ref,       # [B*F, E] f32 gathered rows, E = K*C factor-major
    logits_ref,  # out [B] f32
    *out_refs,   # combined: one [B*F, 2E] ref (g in [:E], g^2 in [E:]);
                 # split: two [B*F, E] refs (g, g^2)
    f: int,
    c: int,
    k: int,
    aug_lane: int,
):
    e = c * k
    b, rows, fields, x, valid = _sample(fields_ref, vals_ref, f)
    logit = plgpu.load(lin_ref.at[b]) + _pair_logit(
        v_ref, rows, fields, x, valid, c, k
    )
    plgpu.store(logits_ref.at[b], logit)
    gs = (jax.nn.sigmoid(logit) - plgpu.load(y_ref.at[b])) * plgpu.load(
        sw_ref.at[b]
    )
    gx = gs * x                                           # [FP]

    fp, cp = rows.shape[0], _tile(c)
    m = jnp.arange(fp, dtype=jnp.int32)
    lane = jnp.arange(cp, dtype=jnp.int32)
    onehot = jnp.where(
        valid[:, None] & (fields[:, None] == lane[None, :]), 1.0, 0.0
    )                                                     # [FP(n), CP(c)]
    xn = jnp.where(m[:, None] != m[None, :], x[None, :], 0.0)
    r = jnp.broadcast_to(rows[:, None], (fp, cp))
    smask = valid[:, None] & (lane < c)[None, :]

    @pl.loop(0, k)
    def _(kk):
        w = _pair_tile(v_ref, rows, fields, valid, kk, c)
        g = gx[:, None] * _onehot_dot(w.T * xn, onehot)   # [FP(m), CP(c)]
        if aug_lane >= 0:
            # the linear-table gradient gs * x rides in dead lane
            # (k=0, c=aug_lane) of the padded factor row: no occurrence
            # selects that field, so its factor gradient is always zero
            g = jnp.where(
                (lane[None, :] == aug_lane) & (kk == 0), gx[:, None], g
            )
        col = jnp.broadcast_to((kk * c + lane)[None, :], (fp, cp))
        g2 = g * g
        if len(out_refs) == 1:
            out = out_refs[0]
            plgpu.store(out.at[r, col], g.astype(out.dtype), mask=smask)
            plgpu.store(out.at[r, col + e], g2.astype(out.dtype), mask=smask)
        else:
            g_ref, g2_ref = out_refs
            plgpu.store(g_ref.at[r, col], g.astype(g_ref.dtype), mask=smask)
            plgpu.store(g2_ref.at[r, col], g2.astype(g2_ref.dtype), mask=smask)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_fields", "n_factors", "interpret", "combined_out", "out_dtype",
        "aug_lane",
    ),
)
def ffm_fused_logits_grads(
    v: jax.Array,        # [B*F, E] gathered factor rows (factor-major)
    fields: jax.Array,   # [B, F] int32
    vals: jax.Array,     # [B, F] f32
    lin: jax.Array,      # [B] bias + linear logits
    y: jax.Array,        # [B] labels
    sample_w: jax.Array, # [B]
    n_fields: int,
    n_factors: int,
    interpret: bool = False,
    combined_out: bool = True,
    out_dtype=jnp.float32,
    aug_lane: int = -1,
):
    """Fused FFM logits + per-occurrence FTRL gradient payload.

    combined_out=True returns (logits [B], gg2 [B*F, 2E]) where gg2[:, :E]
    is the factor gradient already scaled by gs = (sigmoid(logit) - y) *
    sample_w and gg2[:, E:] its elementwise square: the combined payload
    for the single FTRL scatter (ftrl.py::dense_ftrl_update2).  aug_lane
    >= 0 also writes the linear-table gradient gs * x into that dead lane
    of the factor block (ftrl.py::dense_ftrl_update2_aug).
    combined_out=False returns (logits, g, g2) as separate [B*F, E] arrays
    for the huge-table in-place update (ftrl.py::dense_ftrl_update_inplace),
    whose two scatters target different tables."""
    b, f = fields.shape
    e = v.shape[-1]
    if combined_out:
        out_shape = [jax.ShapeDtypeStruct((b * f, 2 * e), out_dtype)]
    else:
        out_shape = [jax.ShapeDtypeStruct((b * f, e), out_dtype)] * 2
    kernel = functools.partial(
        _train_kernel, f=f, c=n_fields, k=n_factors, aug_lane=aug_lane
    )
    logits, *grads = pl.pallas_call(
        kernel,
        grid=(b,),
        out_shape=[jax.ShapeDtypeStruct((b,), jnp.float32)] + out_shape,
        compiler_params=_PARAMS,
        interpret=interpret,
        name="ffm_fused_logits_grads",
    )(
        fields.reshape(-1).astype(jnp.int32), vals.reshape(-1),
        lin, y, sample_w, v,
    )
    return (logits, *grads)


def _logits_kernel(fields_ref, vals_ref, lin_ref, v_ref, logits_ref, *,
                   f: int, c: int, k: int):
    b, rows, fields, x, valid = _sample(fields_ref, vals_ref, f)
    logit = plgpu.load(lin_ref.at[b]) + _pair_logit(
        v_ref, rows, fields, x, valid, c, k
    )
    plgpu.store(logits_ref.at[b], logit)


@functools.partial(
    jax.jit, static_argnames=("n_fields", "n_factors", "interpret")
)
def ffm_fused_logits(
    v: jax.Array,        # [B*F, E] gathered factor rows (factor-major)
    fields: jax.Array,   # [B, F] int32
    vals: jax.Array,     # [B, F] f32
    lin: jax.Array,      # [B] bias + linear logits
    n_fields: int,
    n_factors: int,
    interpret: bool = False,
) -> jax.Array:
    """Inference-only FFM logits (eval and --predict_data): the training
    kernel's first pass, with no gradient writes at all."""
    b, f = fields.shape
    kernel = functools.partial(_logits_kernel, f=f, c=n_fields, k=n_factors)
    return pl.pallas_call(
        kernel,
        grid=(b,),
        out_shape=jax.ShapeDtypeStruct((b,), jnp.float32),
        compiler_params=_PARAMS,
        interpret=interpret,
        name="ffm_fused_logits",
    )(fields.reshape(-1).astype(jnp.int32), vals.reshape(-1), lin, v)
