"""FTRL-Proximal core: accumulator state, closed-form weights, batched updates.

The reference keeps, for every trainable coordinate, the FTRL accumulator pair
(n, z) plus a lazily-materialized weight w = f(n, z)
(reference: src/include/model/ftrl_model.h:28-50).  This design keeps the
same triple — (n, z, w) tables — but materializes w *eagerly at update time*
instead of lazily at next-touch time (identical values, since w is a pure
function of (n, z) once a row has been touched).  Storing w means the forward
pass gathers exactly one table row per occurrence, like the reference's hot
loop reads lin_w[i] / vec_w[i] directly.

Closed form (reference: src/include/model/ftrl_model.h:28-33):

    w = 0                                             if |z| <= l1
    w = -(z - sgn(z) * l1) / (l2 + (beta + sqrt(n)) / alpha)   otherwise

Accumulator update for a batch-aggregated gradient (reference applies this
per coordinate per sample, src/model/ftrl_model.cpp:66-77; the mini-batch
generalization sums g and g^2 over the batch before one sigma step —
identical to the reference at batch size 1):

    sigma = (sqrt(n + sum_g2) - sqrt(n)) / alpha
    z    += sum_g - sigma * w
    n    += sum_g2

The batched table update is a **dense-accumulator scatter-add**: per-occurrence
(g, g^2) pairs scatter-add into zero-initialized accumulator tables (duplicate
ids within the batch sum naturally — the race-free replacement for the
reference's per-feature mutexes, src/model/ftrl_model.cpp:52-77), then one
fused elementwise pass over the whole table applies the closed form.  Rows
with no touches get G = G2 = 0 and are numerical no-ops.  This trades O(R)
elementwise work per step for a sort-free, gather-free update: the
elementwise pass streams at device-memory bandwidth, while a sorted dedup
materializes many [nnz, row_width] intermediates.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class FtrlParams(NamedTuple):
    """Static FTRL hyper-parameters (closed over by jitted steps)."""

    alpha: float = 1e-4
    beta: float = 1.0
    l1: float = 0.1
    l2: float = 5.0


# "Has this coordinate ever been touched by a real gradient?"  Exact zero
# would be the natural test, but the FFM self-slot gradient is computed by
# cancellation (ops/interactions.py: t - oh_e * xv), and XLA's fusion
# choices — which legitimately differ between compilations of the same math
# (streamed vs device-cached epochs, scan vs standalone steps) — can leave
# O(ulp) cancellation dust (measured ~1e-11 in g, so ~1e-22 in g^2) on
# slots that are mathematically untouched.  An exact-zero test amplifies
# that dust to init magnitude in vec_w: keep_init flips to the closed form,
# which zeros the slot — so two bit-identical training runs could disagree
# at init scale depending on compilation alone.  Any real touch contributes
# g^2 >= ~1e-12 (|g| >= ~1e-6 at logistic-gradient x value scales), so
# 1e-16 separates the regimes by >4 orders of magnitude on either side,
# and tolerates ~10^6 dusty steps of accumulation before a false "touched".
# The converse misclassification — a slot whose every touch so far had
# |g| < 1e-8 (a saturated model meeting a fractional-valued feature for
# the first time) keeps its init weight instead of closed-forming to 0 —
# is accepted: it is loss-invisible at that gradient scale and
# self-corrects on the slot's first non-tiny touch.
UNTOUCHED_N = 1e-16


def ftrl_weights(n: jax.Array, z: jax.Array, p: FtrlParams) -> jax.Array:
    """Closed-form FTRL-Proximal weight from accumulators, elementwise.

    Note sgn in the reference maps 0 -> -1 (src/include/utils/utils.h:15-18),
    but sgn(z) is only evaluated when |z| > l1 >= 0, so z != 0 there and the
    convention never matters.
    """
    sgn_z = jnp.where(z > 0, 1.0, -1.0).astype(z.dtype)
    w = -(z - sgn_z * p.l1) / (p.l2 + (p.beta + jnp.sqrt(n)) / p.alpha)
    return jnp.where(jnp.abs(z) <= p.l1, jnp.zeros_like(w), w)


def ftrl_accumulate(
    n: jax.Array,
    z: jax.Array,
    w: jax.Array,
    sum_g: jax.Array,
    sum_g2: jax.Array,
    p: FtrlParams,
) -> tuple[jax.Array, jax.Array]:
    """One FTRL accumulator step given batch-aggregated g and g^2.

    `w` must be the weight the gradients were computed against (i.e. the
    pre-update materialized weight), matching the reference's read of lin_w[i]
    inside update_linear_nz (src/model/ftrl_model.cpp:68-74).
    """
    sigma = (jnp.sqrt(n + sum_g2) - jnp.sqrt(n)) / p.alpha
    new_z = z + sum_g - sigma * w
    new_n = n + sum_g2
    return new_n, new_z


def scatter_grads(
    shape: tuple,
    ids: jax.Array,
    g: jax.Array,
    g2: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Scatter-add per-occurrence (g, g^2) into dense accumulators of `shape`.

    ids: int32 [N]; entries >= shape[0] (the padding sentinel, one past the
    last row) are dropped.  Duplicate ids accumulate — the deterministic
    replacement for the reference's mutex-serialized read-modify-write
    (src/model/ftrl_model.cpp:66-77).

    ids may be multi-dimensional (e.g. [B, F]); g/g2 then carry the same
    leading dims ([B, F] or [B, F, D]) — scattering with batched index dims
    avoids materializing flattening reshapes of the big gradient tensors.
    """
    zeros = jnp.zeros(shape, dtype=g.dtype)
    sum_g = zeros.at[ids].add(g, mode="drop")
    sum_g2 = zeros.at[ids].add(g2, mode="drop")
    return sum_g, sum_g2


def dense_ftrl_update(
    n_tab: jax.Array,
    z_tab: jax.Array,
    w_tab: jax.Array,
    ids: jax.Array,
    g: jax.Array,
    g2: jax.Array,
    p: FtrlParams,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One batched FTRL step over a whole (n, z, w) table.

    Args:
      n_tab, z_tab, w_tab: accumulators + materialized weights, [R] or [R, D].
        w_tab must be the weights the gradients were computed against; for
        never-touched rows it holds the init value (random factor init under
        "keep_init" semantics, zeros under exact "reference" semantics — see
        Config.factor_semantics).
      ids: int32 [N] flat feature ids; entries >= R are padding and dropped.
      g, g2: per-occurrence gradient and squared gradient, [N] or [N, D].

    Returns:
      (new_n, new_z, new_w).  Untouched rows (G = G2 = 0) keep n, z and w
      bit-exactly: sigma = 0 so z and n are unchanged, and new_w falls back
      to w_tab wherever n stays 0 (preserving the stored init — the
      functional form of the reference's lazy materialization,
      src/model/ftrl_model.cpp:52-59 / src/model/ffm.cpp:72-88).
    """
    sum_g, sum_g2 = scatter_grads(n_tab.shape, ids, g, g2)
    w_f32 = w_tab.astype(n_tab.dtype)
    new_n, new_z = ftrl_accumulate(n_tab, z_tab, w_f32, sum_g, sum_g2, p)
    new_w = jnp.where(new_n > UNTOUCHED_N, ftrl_weights(new_n, new_z, p), w_f32)
    return new_n, new_z, new_w.astype(w_tab.dtype)


def sparse_ftrl_update(
    n_tab: jax.Array,
    z_tab: jax.Array,
    w_tab: jax.Array,
    ids: jax.Array,
    g: jax.Array,
    g2: jax.Array,
    p: FtrlParams,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Touched-rows-only FTRL step: sort -> per-unique-id segment sums ->
    gather rows -> closed form -> scatter back.

    Identical semantics to dense_ftrl_update, but temp memory is O(nnz * D)
    instead of O(R * D) — the right trade for very large tables (R >> nnz),
    where the dense accumulators would not fit in HBM and the full-table
    elementwise pass would dominate.  dense_vs_sparse selection is automatic
    (see select_ftrl_update).
    """
    num = ids.shape[0]
    order = jnp.argsort(ids)
    sids = jnp.take(ids, order)
    sg = jnp.take(g, order, axis=0)
    sg2 = jnp.take(g2, order, axis=0)

    # run-length structure of the sorted id stream
    is_start = jnp.concatenate([jnp.ones((1,), bool), sids[1:] != sids[:-1]])
    seg = jnp.cumsum(is_start) - 1  # run index per occurrence
    sum_g = jax.ops.segment_sum(sg, seg, num_segments=num, indices_are_sorted=True)
    sum_g2 = jax.ops.segment_sum(sg2, seg, num_segments=num, indices_are_sorted=True)

    # representative id per run; never-written slots keep the drop sentinel
    sentinel = n_tab.shape[0]
    uniq = jnp.full((num,), sentinel, dtype=ids.dtype).at[seg].set(
        sids, mode="drop", unique_indices=False
    )

    n_rows = jnp.take(n_tab, uniq, axis=0, mode="clip")
    z_rows = jnp.take(z_tab, uniq, axis=0, mode="clip")
    w_rows = jnp.take(w_tab, uniq, axis=0, mode="clip").astype(n_rows.dtype)
    new_n, new_z = ftrl_accumulate(n_rows, z_rows, w_rows, sum_g, sum_g2, p)
    new_w = jnp.where(new_n > UNTOUCHED_N, ftrl_weights(new_n, new_z, p), w_rows)

    # NOT unique_indices=True: uniq repeats the drop sentinel in every slot
    # past the last run, and duplicate indices under unique_indices=True are
    # documented undefined behavior even when all duplicates get dropped.
    kw = dict(mode="drop", indices_are_sorted=True)
    n_tab = n_tab.at[uniq].set(new_n, **kw)
    z_tab = z_tab.at[uniq].set(new_z, **kw)
    w_tab = w_tab.at[uniq].set(new_w.astype(w_tab.dtype), **kw)
    return n_tab, z_tab, w_tab


def dense_ftrl_update2(
    n_tab: jax.Array,
    z_tab: jax.Array,
    w_tab: jax.Array,
    ids: jax.Array,
    gg2: jax.Array,
    p: FtrlParams,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """dense_ftrl_update with a combined (g || g^2) payload: ONE scatter.

    gg2: [N, 2*D] with g in lanes [:D] and g^2 in [D:] (D = row width; the
    fused FFM kernel emits this layout directly, so no concat materializes).
    One scatter into a [R, 2*D] accumulator halves the scatter count and
    doubles the row size per scattered index vs two separate G/G2 scatters.
    """
    d2 = gg2.shape[-1]
    d = d2 // 2
    acc = jnp.zeros((n_tab.shape[0], d2), gg2.dtype).at[ids].add(gg2, mode="drop")
    if n_tab.ndim == 1:
        sum_g, sum_g2 = acc[:, 0], acc[:, 1]
    else:
        sum_g, sum_g2 = acc[:, :d], acc[:, d:]
    w_f32 = w_tab.astype(n_tab.dtype)
    new_n, new_z = ftrl_accumulate(n_tab, z_tab, w_f32, sum_g, sum_g2, p)
    new_w = jnp.where(new_n > UNTOUCHED_N, ftrl_weights(new_n, new_z, p), w_f32)
    return new_n, new_z, new_w.astype(w_tab.dtype)


def dense_ftrl_update2_aug(
    vec_n: jax.Array,
    vec_z: jax.Array,
    vec_w: jax.Array,
    lin_n: jax.Array,
    lin_z: jax.Array,
    lin_w: jax.Array,
    ids: jax.Array,
    gg2: jax.Array,
    lane: int,
    p: FtrlParams,
):
    """One scatter updates the factor AND linear tables.

    gg2: [N, 2*D] combined payload where lane `lane` of the factor grad
    block (and of its squared block at D + lane) carries the LINEAR-table
    gradient g_lin = gs * x instead of a factor grad.  `lane` is a dead
    lane of the padded factor row (slot (k=0, c=n_fields), which no
    occurrence ever selects — see Config.field_pad), so the payload is the
    plain [N, 2*row_width] combined layout with zero extra columns: one
    scatter feeds both tables' stats, with no separate linear scatter.

    The factor closed-form intentionally also updates the dead lane with
    the linear stats: that lane is never read (inert in the interaction,
    dropped on export), so masking it out would only cost an extra select.

    Returns ((vec_n, vec_z, vec_w), (lin_n, lin_z, lin_w))."""
    d2 = gg2.shape[-1]
    d = d2 // 2
    acc = jnp.zeros((vec_n.shape[0], d2), gg2.dtype).at[ids].add(
        gg2, mode="drop"
    )
    w_f32 = vec_w.astype(vec_n.dtype)
    new_vn, new_vz = ftrl_accumulate(
        vec_n, vec_z, w_f32, acc[:, :d], acc[:, d:], p
    )
    new_vw = jnp.where(new_vn > UNTOUCHED_N, ftrl_weights(new_vn, new_vz, p), w_f32)
    new_ln, new_lz = ftrl_accumulate(
        lin_n, lin_z, lin_w, acc[:, lane], acc[:, d + lane], p
    )
    new_lw = jnp.where(new_ln > UNTOUCHED_N, ftrl_weights(new_ln, new_lz, p), lin_w)
    return (
        (new_vn, new_vz, new_vw.astype(vec_w.dtype)),
        (new_ln, new_lz, new_lw),
    )


def sparse_ftrl_update2(
    n_tab: jax.Array,
    z_tab: jax.Array,
    w_tab: jax.Array,
    ids: jax.Array,
    gg2: jax.Array,
    p: FtrlParams,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """sparse_ftrl_update with a combined (g || g^2) payload.

    One take + one segment_sum over [N, 2*D] instead of two of each — half
    the payload passes of the split form.
    """
    num = ids.shape[0]
    d2 = gg2.shape[-1]
    d = d2 // 2
    order = jnp.argsort(ids)
    sids = jnp.take(ids, order)
    sgg2 = jnp.take(gg2, order, axis=0)

    is_start = jnp.concatenate([jnp.ones((1,), bool), sids[1:] != sids[:-1]])
    seg = jnp.cumsum(is_start) - 1
    sums = jax.ops.segment_sum(sgg2, seg, num_segments=num, indices_are_sorted=True)

    sentinel = n_tab.shape[0]
    uniq = jnp.full((num,), sentinel, dtype=ids.dtype).at[seg].set(
        sids, mode="drop", unique_indices=False
    )

    n_rows = jnp.take(n_tab, uniq, axis=0, mode="clip")
    z_rows = jnp.take(z_tab, uniq, axis=0, mode="clip")
    w_rows = jnp.take(w_tab, uniq, axis=0, mode="clip").astype(n_rows.dtype)
    if n_tab.ndim == 1:
        sum_g, sum_g2 = sums[:, 0], sums[:, 1]
    else:
        sum_g, sum_g2 = sums[:, :d], sums[:, d:]
    new_n, new_z = ftrl_accumulate(n_rows, z_rows, w_rows, sum_g, sum_g2, p)
    new_w = jnp.where(new_n > UNTOUCHED_N, ftrl_weights(new_n, new_z, p), w_rows)

    kw = dict(mode="drop", indices_are_sorted=True)
    n_tab = n_tab.at[uniq].set(new_n, **kw)
    z_tab = z_tab.at[uniq].set(new_z, **kw)
    w_tab = w_tab.at[uniq].set(new_w.astype(w_tab.dtype), **kw)
    return n_tab, z_tab, w_tab


def closed_form_pass(n_tab, z_tab, w_tab, a, p: FtrlParams):
    """The in-place update's elementwise pass over whole (n, z', w, A)
    tables, z' already holding z + sum_g:

        sigma = (sqrt(n + A) - sqrt(n)) / alpha
        z     = z' - sigma * w
        n     = n + A
        w     = closed_form(n, z)   where touched, else keep w

    Plain jnp, elementwise: XLA fuses it into one multi-output pass that
    writes n, z and w in place (see scatter_sum for what keeps it so).

    reference math: src/include/model/ftrl_model.h:28-33 (closed form),
    src/model/ftrl_model.cpp:66-77 (accumulator update)."""
    sigma = (jnp.sqrt(n_tab + a) - jnp.sqrt(n_tab)) / p.alpha
    wf = w_tab.astype(n_tab.dtype)
    new_z = z_tab - sigma * wf
    new_n = n_tab + a
    new_w = jnp.where(new_n > UNTOUCHED_N, ftrl_weights(new_n, new_z, p), wf)
    return new_n, new_z, new_w.astype(w_tab.dtype)


def scatter_sum(shape: tuple, ids: jax.Array, upd: jax.Array) -> jax.Array:
    """Scatter-add upd into a fresh zero table of `shape` (ids >= shape[0]
    are dropped).

    The two barriers keep XLA from rewriting the table into its consumers.
    Without the one on the result, the simplifier folds `t + scatter(0, g)`
    into a scatter into t, which must first copy t while the closed form
    still reads it.  Without the one on the zero, CSE merges the table's
    zeros with the closed form's own table-shaped zeros, and the pass then
    reads a materialized table of zeros.  Either costs a table-sized copy
    per step."""
    zero = jax.lax.optimization_barrier(jnp.zeros((), upd.dtype))
    acc = jnp.broadcast_to(zero, shape).at[ids].add(upd, mode="drop")
    return jax.lax.optimization_barrier(acc)


def dense_ftrl_update_inplace(
    n_tab: jax.Array,
    z_tab: jax.Array,
    w_tab: jax.Array,
    ids: jax.Array,
    g: jax.Array,
    g2: jax.Array,
    p: FtrlParams,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Huge-table dense update: scatter g straight into z, g^2 into ONE
    table-shaped accumulator, then the closed-form pass.

    Rewrites the accumulator step as
        z' = z + sum_g                (in-place scatter; z is donated)
        sigma = (sqrt(n + A) - sqrt(n)) / alpha,  A = scattered sum_g2
        z_new = z' - sigma * w;  n_new = n + A
    — identical math to dense_ftrl_update2, but with one accumulator table
    instead of a [R, 2D] pair: at 1M rows x 640 cols that is 2.56 GB of
    temporary memory instead of 5.1 GB, and one less zero-fill and
    full-table read.  The sorting sparse path is avoided entirely."""
    z_tab = z_tab.at[ids].add(g, mode="drop")
    a = scatter_sum(n_tab.shape, ids, g2)
    return closed_form_pass(n_tab, z_tab, w_tab, a, p)


def select_ftrl_update2(n_rows: int, row_width: int, nnz: int, mode: str = "auto"):
    """Combined-payload variant of select_ftrl_update (same thresholds)."""
    f = select_ftrl_update(n_rows, row_width, nnz, mode)
    return dense_ftrl_update2 if f is dense_ftrl_update else sparse_ftrl_update2


def select_update_kind(
    n_rows: int, row_width: int, nnz: int, mode: str = "auto"
) -> str:
    """Pick the table-update strategy: "dense2" (combined-payload dense
    accumulators), "inplace" (huge tables: z-scatter + single accumulator),
    or "sparse2" (sort/segment, only when even one accumulator table would
    not fit HBM).

    Thresholds: dense2's [R, 2D] accumulator up to ~2 GB; inplace's single
    [R, D] accumulator up to ~4 GB (1M rows x 624 f32 = 2.5 GB passes);
    beyond that, sparse2."""
    if mode == "dense":
        return "dense2"
    if mode == "sparse":
        return "sparse2"
    if mode == "inplace":
        return "inplace" if row_width else "dense2"
    d = max(1, row_width)
    if n_rows <= 4 * nnz and 2 * n_rows * d * 4 <= (2 << 30):
        return "dense2"
    if n_rows * d * 4 <= (4 << 30):
        return "inplace" if row_width else "dense2"
    return "sparse2"


def select_ftrl_update(n_rows: int, row_width: int, nnz: int, mode: str = "auto"):
    """dense_ftrl_update for small tables, sparse for huge ones.

    Derived from select_update_kind (the single source of the dense/sparse
    thresholds — keeping a second copy here diverged once already): the
    split-payload callers map "dense2" to dense and everything bigger
    ("inplace"-regime tables included — the in-place form exists only on
    the unsharded huge-table path) to the touched-rows sparse form.
    Exception: explicit mode="inplace" keeps its historical meaning for
    sharded/legacy callers — the dense analogue.
    """
    if mode == "inplace":
        return dense_ftrl_update
    kind = select_update_kind(n_rows, row_width, nnz, mode)
    return dense_ftrl_update if kind == "dense2" else sparse_ftrl_update


def bias_update(
    bias_n: jax.Array,
    bias_z: jax.Array,
    grad_per_sample: jax.Array,
    p: FtrlParams,
) -> tuple[jax.Array, jax.Array]:
    """FTRL step on the global bias (reference: src/model/ftrl_model.cpp:79-85).

    grad_per_sample: [B] per-sample dL/dlogit (already masked for padding).
    """
    w = ftrl_weights(bias_n, bias_z, p)
    sum_g = jnp.sum(grad_per_sample)
    sum_g2 = jnp.sum(grad_per_sample * grad_per_sample)
    return ftrl_accumulate(bias_n, bias_z, w, sum_g, sum_g2, p)
