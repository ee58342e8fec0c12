"""Batched LR / FM / FFM logit + gradient math (pure XLA formulation).

These re-express the reference's per-sample scalar loops as fixed-shape,
batch-parallel tensor algebra that XLA compiles for any backend.  Fused GPU
kernels for the FFM interaction live in ops/ffm_pallas.py; this module is
the always-available path and their numerical ground truth.

Shapes:  B = batch, F = max nnz per sample (padded), C = n_fields,
K = n_factors.  Padded entries carry value 0.0 (the reference drops
zero-valued features at parse time anyway — src/data/parser.cpp:37,99 — so a
zero value is exactly "not present") and field 0 / a sentinel feature id.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def linear_logits(w_lin: jax.Array, vals: jax.Array, bias: jax.Array) -> jax.Array:
    """logit_b = bias + sum_m w[b,m] * x[b,m].

    reference: src/model/ftrl_model.cpp:44-50 (compute_linear_logit).

    Args:
      w_lin: [B, F] gathered linear weights.
      vals:  [B, F] feature values (0 for padding).
      bias:  scalar.
    """
    return bias + jnp.sum(w_lin * vals, axis=-1)


def fm_logits_and_grads(
    v: jax.Array, vals: jax.Array, lin_logits: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """FM second-order logit (sum-of-squares trick) and per-occurrence grads.

    reference: src/model/fm.cpp:40-67 (compute_fm_logit) and :80-101
    (update_vector_nz: g = grad * (x * sum_vx - v * x^2)).

    Args:
      v:          [B, F, K] gathered factor rows.
      vals:       [B, F] values.
      lin_logits: [B] linear part (bias + <w, x>).

    Returns:
      logits: [B]
      dlogit_dv: [B, F, K] — d logit / d v (multiply by per-sample dL/dlogit
        to get the gradient).
    """
    vx = v * vals[..., None]  # [B, F, K]
    sum_vx = jnp.sum(vx, axis=1)  # [B, K]
    sum_sq = jnp.sum(vx * vx, axis=(1, 2))  # [B]
    logits = lin_logits + 0.5 * (jnp.sum(sum_vx * sum_vx, axis=-1) - sum_sq)
    dlogit_dv = vals[..., None] * sum_vx[:, None, :] - v * (vals * vals)[..., None]
    return logits, dlogit_dv


def ffm_logits_and_grads(
    v: jax.Array,
    fields: jax.Array,
    vals: jax.Array,
    lin_logits: jax.Array,
    n_fields: int,
    n_factors: int,
    compute_grads: bool = True,
    lin_lane: int = -1,
    grad_lane: int = -1,
) -> tuple[jax.Array, jax.Array | None]:
    """FFM field-aware pairwise logit and per-occurrence grads, batched.

    The reference loops over pairs m < n and dots v_i[field_j] with
    v_j[field_i] (src/model/ffm.cpp:57-70).  Rewritten as a field-bucketed
    contraction so the O(F^2 K) pair loop becomes two batched matmuls:

        S[b, c, d, k] = sum_{m: field_m = c} x_m * v[b, m, d, k]
        pair_logit_b  = 0.5 * ( sum_{c,d,k} S[b,c,d,k] * S[b,d,c,k]
                                - sum_{m,k} (x_m * v[b,m,field_m,k])^2 )

    and the gradient on occurrence m's slot (c, k)
    (reference: src/model/ffm.cpp:107-123, g = grad * v_other * x_i * x_j):

        dlogit/dv[b,m,c,k] = x_m * ( S[b, c, field_m, k]
                                     - [c == field_m] * x_m * v[b,m,c,k] )

    Layout: every big tensor keeps the fused row width E = C*K as its minor
    dimension (E = 640 for C'=40, K=16 under Config.field_pad row padding),
    and the one-hot selections over the field axis are contractions and
    *elementwise* one-hot masks — no take_along_axis / generic gathers.

    Args:
      v:      [B, F, E] gathered factor rows, E = n_fields * n_factors, in
              the framework's **factor-major** slot layout (k, c) ->
              k * n_fields + c (see ops/layout.py; the reference's
              field-major layout is used only at import/export).
      fields: [B, F] int32 field index per occurrence (0 for padding — padding
              is inert because its value is 0).
      vals:   [B, F] values.
      lin_logits: [B].
      n_fields: C (static).  n_factors: K (static).
      compute_grads: skip the gradient tensor for predict-only paths.
      lin_lane: when >= 0, dead lane `lin_lane` of each factor row mirrors
        the LINEAR-table weight (Config.field_pad padding; the dead-lane
        aug update maintains the mirror): the linear logit contribution
        sum_m v[m, lin_lane] * x_m is computed here from the already-
        gathered rows (lin_logits then carries only the bias).  Kills the
        separate [B, F] linear-weight gather.  Forward-read only — pass -1
        with bf16 factor tables, where the mirror would quantize the
        linear term (the f32 lin_w gather stays exact).
      grad_lane: when >= 0, dlogit_dv's dead lane is set to x_m so the
        emitted per-occurrence gradient doubles as the linear gradient
        g_lin = gs * x (maintains the mirror through every update path;
        independent of whether the forward read it).

    Returns:
      logits: [B]
      dlogit_dv: [B, F, E] or None
    """
    b, f, e = v.shape
    c, k = n_fields, n_factors
    assert e == c * k
    if lin_lane >= 0:
        # static lane slice (not a gather): the mirrored linear weights
        lin_logits = lin_logits + jnp.sum(v[:, :, lin_lane] * vals, axis=1)
    onehot = jax.nn.one_hot(fields, c, dtype=v.dtype)  # [B, F, C]
    xoh = onehot * vals[..., None]  # [B, F, C]
    # s[b, c, (k,d)] = S[c, d, k] = sum_{m: field_m = c} x_m * v_m[factor k,
    # field d] — one batched matmul contracting the occurrence axis.
    # precision=HIGHEST: an f32 einsum may otherwise run in TF32 on the GPU;
    # f32 reference parity is sensitive to the lost mantissa bits, and this
    # module is the declared numerical ground truth for the fused kernels.
    s = jnp.einsum(
        "bmc,bme->bce", xoh, v, precision=jax.lax.Precision.HIGHEST
    )  # [B, C, E]
    # Swap the bucket/target field roles: s_t[b, d, (k,c)] = s[b, c, (k,d)].
    s_t = (
        s.reshape(b, c, k, c).transpose(0, 3, 2, 1).reshape(b, c, e)
    )
    # cross = sum_{c,d,k} S[c,d,k] * S[d,c,k]: elementwise in one layout.
    cross = jnp.sum(s * s_t, axis=(1, 2))  # [B]
    # Self term: slot (k, c) belongs to field c = slot % C; one-hot makes
    # (sum_c oh_c * v[k,c])^2 == sum_c oh_c * v^2.
    slot_field = jnp.arange(e, dtype=fields.dtype) % c
    oh_e = (fields[..., None] == slot_field).astype(v.dtype)  # [B, F, E]
    xv = v * vals[..., None]
    self_sq = jnp.sum(oh_e * xv * xv, axis=(1, 2))  # [B]
    logits = lin_logits + 0.5 * (cross - self_sq)

    if not compute_grads:
        return logits, None

    # T[b, m, (k,c)] = S[c, field_m, k] = sum_d onehot[b,m,d] * s_t[b,d,(k,c)]
    t = jnp.einsum(
        "bmd,bde->bme", onehot, s_t, precision=jax.lax.Precision.HIGHEST
    )  # [B, F, E]
    dlogit_dv = vals[..., None] * (t - oh_e * xv)
    if grad_lane >= 0:
        # d logit / d (linear weight) = x: the dead lane's factor grad is
        # identically zero, so the select only injects the linear grad
        dlogit_dv = jnp.where(
            jnp.arange(e) == grad_lane, vals[..., None], dlogit_dv
        )
    return logits, dlogit_dv
