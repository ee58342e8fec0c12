"""Model base: state pytree, fixed-shape batches, shared linear/bias path.

The reference's model hierarchy (FtrlModel <- LR/FM/FFM,
src/include/model/ftrl_model.h:15-50) becomes: one `ModelState` pytree of
(n, z, w) tables plus stateless per-model logit/grad functions.  No mutexes —
batching + dense scatter-add accumulation make updates deterministic.

The stored w tables mirror the reference's lin_w / vec_w arrays
(src/include/model/ftrl_model.h:41-48, src/model/ffm.cpp:17-28): the forward
pass gathers one row per occurrence, and each train step refreshes w for
touched rows from the closed form — the eager equivalent of the reference's
lazy `update_linear_w` / `update_vector_w` materialization.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ftrl_ffm_tpu.config import Config
from ftrl_ffm_tpu.ftrl import (
    FtrlParams,
    bias_update,
    dense_ftrl_update,
    dense_ftrl_update2,
    dense_ftrl_update2_aug,
    dense_ftrl_update_inplace,
    ftrl_weights,
    select_update_kind,
    sparse_ftrl_update,
    sparse_ftrl_update2,
)


class Batch(NamedTuple):
    """One fixed-shape padded mini-batch.

    Padding convention: padded occurrences have value 0.0, field 0 and
    feature id == n_feats (a drop sentinel for scatters; gathers clip).
    Padded *samples* (batch remainder) additionally have sample_w 0.0.

    Transfer compaction (Config.compact_transfer) may narrow dtypes and
    delta-encode feats: when feats_base is set, feats holds uint16 deltas
    against per-column bases feats_base[:F], with delta 65535 reserved for
    the padding sentinel feats_base[F].  widen_batch decodes on device.
    When the per-column delta encoding fails (ids spread past uint16 —
    shuffled-token-order data), feats may instead ride the SPLIT tier:
    feats holds the ids' low 16 bits (uint16) and feats_base (uint8,
    [B, k, ceil(F/8)]) holds the high k = bit_length(n_feats) - 16 bits as
    MSB-first bit-packed bitplanes (plane i = bit 16+i of the id) — 2.03
    instead of 4 bytes/id at Criteo's 100k ids (k=1), lossless for any
    n_feats < 2^24, and static per run (the tier depends only on
    cfg.n_feats, so the jit cache stays bounded).  Non-sharded runs only
    (the sharded batch pspecs pin feats_base replicated; the split plane
    is per-sample).
    Three zero-size markers cut upload bytes further: fields may be [B, 0]
    (LR/FM never read field ids), fields may be [0, F] (every row's fields
    are exactly 0..F-1 — one feature per field in slot order, the canonical
    CTR case — reconstructed as an iota on device), and vals may be [B, 0]
    (an exactly-all-1.0 batch with no padding, reconstructed as ones).
    """

    fields: jax.Array  # [B, F] int32 (or int8/int16 compacted)
    feats: jax.Array   # [B, F] int32 (or uint16 deltas, see feats_base)
    vals: jax.Array    # [B, F] float32 (or int8/bfloat16 when exact, or
                       # [B, 3F] uint8 DEC6 fixed-point — see widen_batch)
    y: jax.Array       # [B] float32 in {0, 1} (or int8)
    sample_w: jax.Array  # [B] float32 (or int8 when integral)
    feats_base: Optional[jax.Array] = None  # [F+1] int32: bases + sentinel


class ModelState(NamedTuple):
    """(n, z, w) triples for every trainable table.

    Mirrors the reference's (bias_n, bias_z), (lin_w, lin_w_n, lin_w_z) and
    (vec_w, vec_w_n, vec_w_z) arrays (src/include/model/ftrl_model.h:41-48,
    src/model/ffm.cpp:17-28).  The bias weight is derived on the fly (scalar).
    vec_w doubles as the random factor init for untouched rows ("keep_init"
    semantics) or starts at zero (exact "reference" semantics); see
    Config.factor_semantics.
    """

    bias_n: jax.Array
    bias_z: jax.Array
    lin_n: jax.Array   # [R]
    lin_z: jax.Array   # [R]
    lin_w: jax.Array   # [R]
    vec_n: Optional[jax.Array]   # [R, D] or None
    vec_z: Optional[jax.Array]   # [R, D] or None
    vec_w: Optional[jax.Array]   # [R, D] or None
    step: jax.Array    # int32 scalar


class TrainOut(NamedTuple):
    state: ModelState
    logits: jax.Array       # [B] pre-update logits (train loss accounting,
                            # like reference src/task/ftrl_online.cpp:70-80)
    loss_sum: jax.Array     # scalar: sum of per-sample log-loss (masked)
    count: jax.Array        # scalar: number of real samples
    route_overflow: Optional[jax.Array] = None  # scalar int32: occurrences
                            # dropped by routed-lookup capacity this step
                            # (route mode only; None elsewhere)


def dec6_decode(k: jax.Array) -> jax.Array:
    """Correctly-rounded k/1e6 (k int < 2^24) from f32 mul/add only.
    A device's division may be reciprocal-based and land 1 ulp off for a
    few percent of ks, so a plain divide need not reproduce the host's
    strtof-equal division.  This sequence does on any IEEE f32 device:
    q0 = k·r, then one correction with the EXACT residual k − q0·1e6
    obtained via a Veltkamp two-product (no FMA needed).
    Trainer._dec6_device_ok re-verifies a sample per process before the
    tier may engage (chip_smoke.py checks all 2^24 ks on the GPU).
    Barriers keep XLA from folding the constants back into a reciprocal."""
    kf = k.astype(jnp.float32)
    d = jax.lax.optimization_barrier(jnp.float32(1e6))
    r = jax.lax.optimization_barrier(jnp.float32(1e-6))
    q0 = kf * r
    c = jnp.float32((1 << 12) + 1)

    def split(x):
        t = c * x
        hi = t - (t - x)
        return hi, x - hi

    qh, ql = split(q0)
    dh, dl = split(d)
    p = q0 * d
    e = (((qh * dh - p) + qh * dl) + ql * dh) + ql * dl  # q0·d == p + e
    res = (kf - p) - e
    return q0 + res * r


def widen_batch(b: Batch) -> Batch:
    """Cast a (possibly transfer-compacted) batch to canonical dtypes.

    The host pipeline may upload fields as int8/int16, values as
    int8/bfloat16, labels/sample weights as int8, and feature ids as uint16
    deltas against per-column bases to cut host->HBM transfer bytes
    (Config.compact_transfer); widening on device is free (fused casts +
    one [B, F] add).  No-op for already-canonical batches."""
    feats = b.feats.astype(jnp.int32)
    # decode keys off the (trace-static) dtype: uint16 feats are deltas
    # (int32 feats_base) or split-tier low halves (uint8 feats_base); a
    # feats_base rides along even when unused (sharded pytrees need a stable
    # structure) and is ignored for int32 feats
    if b.feats_base is not None and b.feats.dtype == jnp.uint16:
        if b.feats_base.dtype == jnp.uint8:
            # split tier: feats = id & 0xFFFF; feats_base [..., k, P] holds
            # bit 16+i of each id, MSB-first-packed along F (np.packbits)
            f = b.feats.shape[-1]
            k = b.feats_base.shape[-2]
            j = jnp.arange(f)
            byte = jnp.take(
                b.feats_base.astype(jnp.int32), j // 8, axis=-1
            )  # [..., k, F]
            bits = (byte >> (7 - (j % 8))) & 1
            hi = jnp.sum(
                bits << (16 + jnp.arange(k))[..., None], axis=-2
            ) if k else 0
            feats = feats + hi
        else:
            base = b.feats_base[..., :-1]   # [F] per-column id base
            sent = b.feats_base[..., -1:]   # [1] the padding sentinel
            feats = jnp.where(feats == 65535, sent, base + feats)
    # zero-width vals = the all-ones full-batch marker (shape is
    # trace-static, so this costs nothing per step)
    if b.vals.shape[-1] == 0 and feats.shape[-1] != 0:
        vals = jnp.ones(feats.shape, jnp.float32)
    elif b.vals.dtype == jnp.uint8:
        # DEC6 tier: vals are 6-decimal fixed-point k·10⁻⁶ shipped as
        # 3 little-endian bytes per value ([..., 3F] uint8).  The host
        # verified v == f32(k)/f32(1e6) (correctly-rounded division
        # reproduces strtof("%.6f") bit-exactly) and dec6_decode computes
        # exactly that on any device, so training numerics are unchanged.
        u = b.vals.astype(jnp.int32)
        k = u[..., 0::3] + (u[..., 1::3] << 8) + (u[..., 2::3] << 16)
        vals = dec6_decode(k)
    else:
        vals = b.vals.astype(jnp.float32)
    # bit-packed fields: [..., w, ceil(F/8)] uint8 bitplanes (plane i =
    # bit i of the field id, MSB-first along F — train.py::_pack_bitplanes;
    # w = bit_length(n_fields - 1), e.g. 6 bits for 39 fields vs 8 as i8).
    # Detected by rank: one more axis than feats.
    if b.fields.ndim == feats.ndim + 1 and b.fields.dtype == jnp.uint8:
        f = feats.shape[-1]
        w = b.fields.shape[-2]
        j = jnp.arange(f)
        byte = jnp.take(b.fields.astype(jnp.int32), j // 8, axis=-1)
        bits = (byte >> (7 - (j % 8))) & 1
        fields = jnp.sum(bits << jnp.arange(w)[..., None], axis=-2)
        return Batch(
            fields=fields,
            feats=feats,
            vals=vals,
            y=b.y.astype(jnp.float32),
            sample_w=b.sample_w.astype(jnp.float32),
        )
    # zero-ROW fields [..., 0, F] = the iota marker (every row's fields are
    # exactly 0..F-1, the canonical one-feature-per-field layout); padded
    # slots get field j instead of the parser's 0, which is numerically
    # inert (their val is 0) — and the marker is only taken on pad-free
    # batches anyway (train.py::_compact)
    if b.fields.ndim >= 2 and b.fields.shape[-2] == 0 and feats.shape[-1]:
        fields = jax.lax.broadcasted_iota(
            jnp.int32, feats.shape, feats.ndim - 1
        )
    else:
        fields = b.fields.astype(jnp.int32)
    return Batch(
        fields=fields,
        feats=feats,
        vals=vals,
        y=b.y.astype(jnp.float32),
        sample_w=b.sample_w.astype(jnp.float32),
    )


def take_cached(ds, ix, n_real) -> Batch:
    """Gather one batch from a device-resident dataset (Config.device_cache).

    ds: (fields, feats, vals, y) arrays carrying one extra inert tail row
    (feat id = sentinel, value 0) that padded permutation indices (ix ==
    n_real... n) point at; sample_w marks them 0.  fields/vals may be
    dataset-level zero-size markers (see Trainer._ensure_device_cache) and
    are then re-emitted in the streamed feeder's marker shapes, so
    widen_batch and the kernels keep the exact canonical-content
    specializations ([0, F] fields = iota, [B, 0] vals = ones) that the
    per-batch compact path gets (losing them slows every step on
    canonical CTR data).  Runs unsharded
    or per-device inside shard_map (ix is then the device's slice of the
    batch's index row)."""
    fields, feats, vals, y = ds
    b = ix.shape[0]
    if fields.shape[0] == 0 and fields.shape[-1] == 0:
        fields_b = jnp.zeros((b, 0), jnp.int32)  # LR/FM: fields unread
    elif fields.shape[0] == 0:
        fields_b = fields  # [0, F] iota marker, pass through
    else:
        fields_b = jnp.take(fields, ix, axis=0)
    if vals.shape[0] == 0:
        # all-ones marker: widen_batch reconstructs ones for every row,
        # including pad-index rows (sample_w 0 + the feat-id drop sentinel
        # keep those inert regardless of their values)
        vals_b = jnp.zeros((b, 0), jnp.float32)
    else:
        vals_b = jnp.take(vals, ix, axis=0)
    return Batch(
        fields=fields_b,
        feats=jnp.take(feats, ix, axis=0),
        vals=vals_b,
        y=jnp.take(y, ix, axis=0),
        sample_w=(ix < n_real).astype(jnp.float32),
    )


def state_formats(state: ModelState, device=None):
    """Row-major layout pins for the 2-D factor tables (or None: don't pin).

    XLA's entry-layout heuristic minimizes tile padding, which makes [R, E]
    tables COLUMN-major at the jit boundary whenever E is not a lane
    multiple (pre-padding E = 624 padded 2.6% row-major vs 0.1%
    column-major; Config.field_pad now makes the flagship E = 640 exactly
    aligned, where row-major is the natural choice — the pin then just
    locks it in).  Every op inside the step wants row-major, so an
    un-pinned mis-laid-out step pays six table-sized transpose copies per
    call.  Pinning Format(Layout((0, 1))) on the donated
    state keeps gather -> kernel -> scatter -> closed-form in one layout end
    to end.  Narrow rows (FM's E=k) genuinely belong column-major — lane
    padding would blow the table up — so we only pin when the row pads
    lightly."""
    from jax.experimental.layout import Format, Layout
    from jax.sharding import SingleDeviceSharding

    if state.vec_n is None:
        return None
    e = state.vec_n.shape[-1]
    if ((-e) % 128) * 10 > e:  # >10% lane padding: leave layouts to XLA
        return None
    dev = device if device is not None else jax.devices()[0]
    sds = SingleDeviceSharding(dev)
    rm = Format(Layout(major_to_minor=(0, 1)), sds)
    auto = Format(None, sds)
    return ModelState(
        bias_n=auto, bias_z=auto,
        lin_n=auto, lin_z=auto, lin_w=auto,
        vec_n=rm, vec_z=rm, vec_w=rm,
        step=auto,
    )


def binary_logloss(logits: jax.Array, y: jax.Array) -> jax.Array:
    """Numerically stable -y*log(s) - (1-y)*log(1-s) from the logit.

    reference: src/include/eval/loss.h:8-12 (naive double-precision form).
    """
    return jax.nn.softplus(logits) - y * logits


class Model:
    """Shared init / step plumbing; subclasses provide the interaction math."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.params = FtrlParams(cfg.w_alpha, cfg.w_beta, cfg.w_l1, cfg.w_l2)
        self.n_feats = cfg.n_feats
        self.row_width = cfg.row_width

    # ---- state ----
    def init(self, key: jax.Array | None = None) -> ModelState:
        if key is None:
            key = jax.random.PRNGKey(self.cfg.seed)
        r = self.n_feats
        if self.row_width:
            vec_n = jnp.zeros((r, self.row_width), jnp.float32)
            vec_z = jnp.zeros((r, self.row_width), jnp.float32)
            w_dtype = jnp.dtype(self.cfg.table_dtype)
            if self.cfg.factor_semantics == "reference":
                # reference lazy materialization: first touch writes
                # w = f(n=0, z=0) = 0, so factors never leave zero
                # (src/model/ffm.cpp:72-88) — init is irrelevant.
                vec_w = jnp.zeros((r, self.row_width), w_dtype)
            else:
                # Gaussian init like utils::init_weights
                # (reference: src/include/utils/utils.h:38-61), kept until a
                # row is first touched (alphaFM-style "keep_init").
                vec_w = (
                    self.cfg.init_mean
                    + self.cfg.init_stddev
                    * jax.random.normal(key, (r, self.row_width), jnp.float32)
                )
                cp, c = self.cfg.field_pad, self.cfg.n_fields
                if cp > c:
                    # dead lanes (slots (k, c') with c' >= n_fields under
                    # field_pad row padding) start at zero: they are inert
                    # in the interaction either way, but lane (0, n_fields)
                    # mirrors the linear table (init 0) through the
                    # dead-lane aug update, and zeroed padding keeps
                    # exported/checkpointed states clean
                    lane_field = jnp.arange(self.row_width) % cp
                    vec_w = jnp.where(lane_field < c, vec_w, 0.0)
                vec_w = vec_w.astype(w_dtype)
        else:
            vec_n = vec_z = vec_w = None
        return ModelState(
            bias_n=jnp.zeros((), jnp.float32),
            bias_z=jnp.zeros((), jnp.float32),
            lin_n=jnp.zeros((r,), jnp.float32),
            lin_z=jnp.zeros((r,), jnp.float32),
            # linear init is irrelevant in the reference for the same lazy-
            # materialization reason (src/model/ftrl_model.cpp:52-59): w = 0.
            lin_w=jnp.zeros((r,), jnp.float32),
            vec_n=vec_n,
            vec_z=vec_z,
            vec_w=vec_w,
            step=jnp.zeros((), jnp.int32),
        )

    # ---- gathered weights (single gather per table — w is stored) ----
    def _gather_linear(self, state: ModelState, feats: jax.Array):
        return jnp.take(state.lin_w, feats, mode="clip")

    def _gather_vec(self, state: ModelState, feats: jax.Array):
        # bf16 tables halve the gather's HBM traffic; compute stays f32
        return jnp.take(state.vec_w, feats, axis=0, mode="clip").astype(jnp.float32)

    def bias_weight(self, state: ModelState) -> jax.Array:
        return ftrl_weights(state.bias_n, state.bias_z, self.params)

    # ---- to be provided by subclasses ----
    def _logits_and_grads(self, state: ModelState, batch: Batch, train: bool):
        """Returns (logits [B], dlogit_dv or None) with gradients w.r.t. the
        factor tables; linear/bias grads are model-independent."""
        raise NotImplementedError

    # ---- public API ----
    def predict_logits(self, state: ModelState, batch: Batch) -> jax.Array:
        logits, _ = self._logits_and_grads(state, widen_batch(batch), train=False)
        return logits

    def predict_proba(self, state: ModelState, batch: Batch) -> jax.Array:
        return jax.nn.sigmoid(self.predict_logits(state, batch))

    def _train_grads(
        self,
        state: ModelState,
        batch: Batch,
        split: bool,
        payload_dtype=None,
        aug: bool = False,
    ):
        """(logits, payload, aug_done) for one train step; payload is None
        (LR), (gg2 [B*F, 2D],) with the factor gradient (already scaled by
        gs = (sigmoid(logit) - y) * sample_w) in lanes [:D] and its square
        in [D:] — the combined payload for the single FTRL scatter — or,
        when split=True (huge-table in-place update), separate
        (g [B*F, D], g2 [B*F, D]).  Subclasses may fuse this (the FFM
        Pallas kernel emits either layout directly).  payload_dtype narrows
        the emitted payload (Config.acc_dtype).  aug_done=True means the
        linear-table gradient rides in the payload's dead lane
        (ftrl.py::dense_ftrl_update2_aug) — this base implementation never
        does that."""
        logits, dlogit_dv = self._logits_and_grads(state, batch, train=True)
        if dlogit_dv is None:
            return logits, None, False
        gs = (jax.nn.sigmoid(logits) - batch.y) * batch.sample_w
        g_vec = gs[:, None, None] * dlogit_dv.reshape(
            dlogit_dv.shape[0], dlogit_dv.shape[1], -1
        )
        g_vec = g_vec.reshape(g_vec.shape[0] * g_vec.shape[1], -1)
        g2_vec = g_vec * g_vec
        if payload_dtype is not None:
            g_vec = g_vec.astype(payload_dtype)
            g2_vec = g2_vec.astype(payload_dtype)
        if split:
            return logits, (g_vec, g2_vec), False
        return logits, (jnp.concatenate([g_vec, g2_vec], axis=-1),), False

    def _emits_combined(self) -> bool:
        """True when the grad producer can emit the combined (g || g^2)
        layout for free (the fused kernel writes it directly).  The XLA
        formulation would need a materializing concat, so it prefers split
        payloads + the two-scatter update."""
        return False

    def _emits_aug_combined(self) -> bool:
        """True when the grad producer can additionally fold the linear
        gradient into the combined payload's dead lane
        (ftrl.py::dense_ftrl_update2_aug — one scatter updates both
        tables).  Requires a padded factor row (Config.field_pad >
        n_fields) so a dead lane exists."""
        return False

    def _lin_mirror_maintained(self) -> bool:
        """True when the factor tables' dead lane carries a complete,
        forward-read linear-table mirror (FFM with field_pad and f32
        tables): the huge-table in-place update may then skip the separate
        linear-table scatter entirely and let the lin arrays ride stale
        through training (Trainer reconciles them from the mirror at
        checkpoint/export boundaries via sync_lin_from_mirror)."""
        return False

    def sync_lin_from_mirror(self, state: ModelState) -> ModelState:
        """Reconcile the linear tables from the factor tables' mirror lane
        (no-op unless the model maintains one — see FFM)."""
        return state

    def train_step(self, state: ModelState, batch: Batch) -> TrainOut:
        """One deterministic mini-batch FTRL step (== reference FFM::train
        pipeline, src/model/ffm.cpp:38-50, vectorized over the batch)."""
        p = self.params
        batch = widen_batch(batch)
        nnz = batch.feats.shape[0] * batch.feats.shape[1]
        vec_kind = None
        if state.vec_n is not None:
            vec_kind = select_update_kind(
                state.vec_n.shape[0], state.vec_n.shape[-1], nnz,
                self.cfg.update_mode,
            )
        split = vec_kind == "inplace" or not self._emits_combined()
        # bf16 payload/accumulator only for the dense combined path: the
        # in-place update scatters g into the f32 z table directly, and the
        # sparse path's long segment sums want f32 accumulation
        payload_dtype = (
            jnp.bfloat16
            if self.cfg.acc_dtype == "bfloat16" and vec_kind == "dense2"
            and not split
            else None
        )
        want_aug = (
            vec_kind == "dense2"
            and not split
            and self.cfg.field_pad > self.cfg.n_fields
            and self._emits_aug_combined()
        )
        logits, payload, is_aug = self._train_grads(
            state, batch, split=split, payload_dtype=payload_dtype,
            aug=want_aug,
        )
        # dL/dlogit = sigmoid(logit) - y  (reference: src/model/ffm.cpp:44)
        gs = (jax.nn.sigmoid(logits) - batch.y) * batch.sample_w  # [B]
        ids = batch.feats.reshape(-1)
        bias_n, bias_z = bias_update(state.bias_n, state.bias_z, gs, p)

        if is_aug:
            (vec_n, vec_z, vec_w), (lin_n, lin_z, lin_w) = (
                dense_ftrl_update2_aug(
                    state.vec_n, state.vec_z, state.vec_w,
                    state.lin_n, state.lin_z, state.lin_w,
                    ids, payload[0], self.cfg.n_fields, p,
                )
            )
            count = jnp.sum(batch.sample_w)
            per_loss = binary_logloss(logits, batch.y) * batch.sample_w
            return TrainOut(
                state=ModelState(
                    bias_n=bias_n, bias_z=bias_z,
                    lin_n=lin_n, lin_z=lin_z, lin_w=lin_w,
                    vec_n=vec_n, vec_z=vec_z, vec_w=vec_w,
                    step=state.step + (count > 0).astype(jnp.int32),
                ),
                logits=logits,
                loss_sum=jnp.sum(per_loss),
                count=count,
            )

        if vec_kind == "inplace" and self._lin_mirror_maintained():
            # Huge-table path with a dead-lane linear mirror: every payload
            # (kernel aug_lane / XLA grad_lane) already carries g_lin, so the
            # in-place factor update maintains complete linear stats in the
            # mirror lane.  Skip the separate [nnz, 2] linear scatter — the
            # lin arrays ride stale and are reconciled from the mirror at
            # checkpoint/export boundaries
            # (Trainer._maybe_sync_lin -> sync_lin_from_mirror).
            lin_n, lin_z, lin_w = state.lin_n, state.lin_z, state.lin_w
        else:
            # Linear table: g = gs * x (reference:
            # src/model/ftrl_model.cpp:66-77).  Flat [nnz] streams keep the
            # gather->kernel->scatter chain in one row-major 2-D layout
            # (no relayout copies).
            g_lin = (gs[:, None] * batch.vals).reshape(-1)
            gg2_lin = jnp.stack([g_lin, g_lin * g_lin], axis=-1)  # [nnz, 2]
            lin_kind = select_update_kind(
                state.lin_n.shape[0], 0, nnz, self.cfg.update_mode
            )
            lin_update = (
                sparse_ftrl_update2
                if lin_kind == "sparse2"
                else dense_ftrl_update2
            )
            lin_n, lin_z, lin_w = lin_update(
                state.lin_n, state.lin_z, state.lin_w, ids, gg2_lin, p
            )

        vec_n, vec_z, vec_w = state.vec_n, state.vec_z, state.vec_w
        if payload is not None:
            if vec_kind == "inplace":
                vec_n, vec_z, vec_w = dense_ftrl_update_inplace(
                    state.vec_n, state.vec_z, state.vec_w, ids, *payload, p
                )
            elif len(payload) == 2:  # split (XLA fallback): two scatters
                vec_update = (
                    sparse_ftrl_update
                    if vec_kind == "sparse2"
                    else dense_ftrl_update
                )
                vec_n, vec_z, vec_w = vec_update(
                    state.vec_n, state.vec_z, state.vec_w, ids, *payload, p
                )
            else:
                vec_update = (
                    sparse_ftrl_update2
                    if vec_kind == "sparse2"
                    else dense_ftrl_update2
                )
                vec_n, vec_z, vec_w = vec_update(
                    state.vec_n, state.vec_z, state.vec_w, ids, payload[0], p
                )

        count = jnp.sum(batch.sample_w)
        new_state = ModelState(
            bias_n=bias_n,
            bias_z=bias_z,
            lin_n=lin_n,
            lin_z=lin_z,
            lin_w=lin_w,
            vec_n=vec_n,
            vec_z=vec_z,
            vec_w=vec_w,
            # inert (fully padded) batches don't count as steps — they arise
            # as scan-group remainder padding and are numerical no-ops
            step=state.step + (count > 0).astype(jnp.int32),
        )
        per_loss = binary_logloss(logits, batch.y) * batch.sample_w
        return TrainOut(
            state=new_state,
            logits=logits,
            loss_sum=jnp.sum(per_loss),
            count=count,
        )

    def eval_step(self, state: ModelState, batch: Batch):
        """Masked log-loss sum + count for one eval batch
        (reference: src/eval/evaluate.cpp:23-33)."""
        batch = widen_batch(batch)
        logits = self.predict_logits(state, batch)
        per_loss = binary_logloss(logits, batch.y) * batch.sample_w
        return jnp.sum(per_loss), jnp.sum(batch.sample_w), logits

    def has_zero_weights(self, state: ModelState, table: str = "linear") -> bool:
        """True if L1 has produced exact zeros among *touched* weights of
        `table` ("linear", "factor", or "any") — the reference's
        sparsification check.  utils::has_zero_weights accepts any weights
        vector (src/include/utils/utils.h:63-76); the reference only ever
        feeds it lin_w (src/task/ftrl_online.cpp:96-110, asserted after
        training in tests/test_task.cpp), but the factor tables are equally
        checkable here."""
        # the huge-table in-place path leaves lin tables stale (the mirror
        # lane is authoritative) — reconcile first; a no-op elsewhere
        state = self.sync_lin_from_mirror(state)

        def zeros_among_touched(n_tab, w_tab):
            # untouched rows are zero by construction here (the reference
            # keeps a nonzero gaussian init on untouched rows), so restrict
            # to touched coordinates — the same dust-proof threshold as the
            # update paths (ftrl.UNTOUCHED_N): an exact-zero test would call
            # cancellation-dust slots "touched" and give a compilation-
            # dependent answer for the same trained state
            from ftrl_ffm_tpu.ftrl import UNTOUCHED_N

            touched = n_tab > UNTOUCHED_N
            return bool(jnp.any(jnp.logical_and(touched, w_tab == 0.0)))

        if table not in ("linear", "factor", "any"):
            raise ValueError(f"unknown table {table!r}")
        lin = table in ("linear", "any") and zeros_among_touched(
            state.lin_n, state.lin_w
        )
        if lin or table == "linear":
            return lin
        if state.vec_n is None:
            return False
        vec_n, vec_w = state.vec_n, state.vec_w
        cp, c = self.cfg.field_pad, self.cfg.n_fields
        if cp > c:
            # exclude dead lanes (slots (k, c') with c' >= n_fields): lane
            # (0, n_fields) mirrors the LINEAR table (models/ffm.py), so
            # counting it would report linear zeros as factor sparsity
            genuine = (jnp.arange(vec_n.shape[-1]) % cp) < c
            vec_n = jnp.where(genuine, vec_n, 0.0)
        return zeros_among_touched(vec_n, vec_w)

    # ---- import (reference weights -> trainable state) ----
    def _import_vec_layout(self, vec_w):
        """Hook: convert the reference's factor-row layout to the internal
        one (inverse of _export_vec_layout)."""
        return vec_w

    def init_from_weights(self, bias, lin_w, vec_w=None) -> ModelState:
        """Build a state whose materialized weights equal the given
        reference-layout weights — the interop path for models trained by
        the C++ binary (reference: src/model/{lr,ffm}.cpp load paths, which
        likewise restore only w and leave n/z at zero).

        Exact inversion of the closed form at n = 0:
            w = -(z - sgn(z) l1) / (l2 + beta / alpha)
            => z = -w * (l2 + beta / alpha) - sign(w) * l1   (w != 0)
        so the first training touch sees exactly these weights and FTRL
        continues naturally."""
        p = self.params
        d = p.l2 + p.beta / p.alpha

        def z_of(w):
            return jnp.where(w != 0.0, -w * d - jnp.sign(w) * p.l1, 0.0)

        state = self.init()
        lin_w = jnp.asarray(lin_w, jnp.float32).reshape(state.lin_w.shape)
        bias = jnp.asarray(bias, jnp.float32).reshape(())
        state = state._replace(
            bias_z=z_of(bias),
            lin_w=lin_w,
            lin_z=z_of(lin_w),
        )
        if vec_w is not None:
            vw = jnp.asarray(
                self._import_vec_layout(np.asarray(vec_w)), jnp.float32
            ).reshape(state.vec_w.shape)
            state = state._replace(
                vec_w=vw.astype(state.vec_w.dtype), vec_z=z_of(vw)
            )
        return state

    # ---- export (reference weight-layout materialization) ----
    def _export_vec_layout(self, vec_w):
        """Hook: convert the internal factor-row layout to the reference's
        (FFM rows are stored factor-major internally, see ops/layout.py)."""
        return vec_w

    def materialize_weights(self, state: ModelState):
        """Dense (bias, lin_w[, vec_w]) in the reference's save layout
        (reference: src/model/ffm.cpp:138-147).  w tables are stored, so this
        is a read-out; untouched factor rows hold the init under keep_init
        semantics (zero under reference semantics), untouched linear rows 0.

        REQUIRES a logical-row-order state: pass Trainer.logical_state (or
        any unsharded state) — a mesh-sharded state's physical rows are
        modulo-interleaved and slicing them here would export scrambled
        weights.  Tables are sliced to the logical n_feats: under mesh_model sharding
        pad_state_tables may have zero-padded rows to a multiple of the shard
        count, and the reference blob layout (import side slices at fixed
        offsets 1:1+n_feats) must not see the padding.
        """
        n = self.cfg.n_feats
        lin_w = state.lin_w[:n]
        vec_w = state.vec_w
        if vec_w is not None:
            vec_w = self._export_vec_layout(vec_w[:n])
        return self.bias_weight(state), lin_w, vec_w
