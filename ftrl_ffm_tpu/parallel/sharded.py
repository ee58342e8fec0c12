"""The sharded FTRL train/eval step: shard_map over a ("data", "model") mesh.

Replaces the reference's hogwild thread parallelism
(reference: src/task/ftrl_offline.cpp:85-100, per-feature mutexes at
src/include/model/ftrl_model.h:49) with deterministic SPMD.  Feature tables
are row-sharded over "model" with modulo-interleaved placement (feature id
lives on shard id % M — see parallel/mesh.py::interleave_ids), the batch is
row-sharded over devices, and two lookup strategies exist (Config.lookup_mode):

**replicate** (small meshes): batch sharded over "data" only; each table
shard gathers its local rows for the full local batch (others contribute 0)
and a `psum` over "model" assembles full weight rows on every device.  Exact
and simple, but every model shard does O(nnz * E) gather work and the psum
moves full-width tensors — the right shape only while mesh_model is small.

**route** (the scalable form — SURVEY §2b:101, §2c:114-118): batch sharded
over BOTH axes (compute scales with every device).  Each device buckets its
flat physical ids by owner shard into fixed-capacity send buffers
(K = route_capacity * nnz_local / M per peer), `all_to_all` over "model"
delivers id requests to owners, owners gather local rows, a second
`all_to_all` returns them; the update path routes the combined (g || g^2)
payloads to owners through the same buckets, then each owner scatter-adds
into its local accumulator.  Per-device traffic and gather work are
O(nnz * E / n_devices) — independent of mesh_model.  Routing is by UNIQUE
id (all occurrences of an id share a slot; duplicates aggregate before the
wire — see _route), so id skew cannot overflow the buckets; the residual
adversarial overflow case (more DISTINCT ids per owner than route_k) drops
those ids' occurrences, is counted per step (TrainOut.route_overflow,
surfaced in Trainer history), warned via jax.debug, and optionally raised
(Config.route_overflow_policy).

The update defaults to the dense-accumulator form: scatter-add combined
(g, g^2) into local-table-shaped accumulators, `psum` over "data" completes
the global per-feature sums, one fused elementwise pass applies the
closed-form FTRL step — one deterministic update per feature id per step, no
races by construction.  Huge shards switch forms: replicate mode all_gathers
the (id, payload) stream and updates touched rows only; route mode on a
(1, N) mesh (no cross-replica psum) takes the in-place z-scatter + single
accumulator + streamed closed-form pass.  All collectives are XLA (`psum`,
`all_to_all`) and ride ICI on a real slice.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ftrl_ffm_tpu.config import Config
from ftrl_ffm_tpu.ftrl import (
    UNTOUCHED_N,
    FtrlParams,
    ftrl_accumulate,
    ftrl_weights,
    select_ftrl_update2,
    sparse_ftrl_update2,
)
from ftrl_ffm_tpu.models.base import (
    Batch,
    ModelState,
    TrainOut,
    binary_logloss,
    widen_batch,
)
from ftrl_ffm_tpu.ops.interactions import (
    ffm_logits_and_grads,
    fm_logits_and_grads,
    linear_logits,
)
from ftrl_ffm_tpu.parallel.mesh import interleave_ids


class Routing(NamedTuple):
    """Per-step id routing tables (route mode), shared by lookup and update."""

    slot: jax.Array      # [n] int32: send-buffer slot per occurrence (M*K =
                         # dropped); occurrences of the same id share a slot
    valid: jax.Array     # [n] bool: routed successfully
    recv: jax.Array      # [M*K] int32: local rows requested of this shard (Rl = none)
    overflow: jax.Array  # scalar int32: occurrences dropped by capacity


def _resolve_lookup_mode(cfg: Config, mesh: Mesh) -> str:
    m = mesh.shape["model"]
    if m == 1 or cfg.lookup_mode == "replicate":
        return "replicate"
    n_dev = mesh.shape["data"] * m
    if cfg.lookup_mode == "route":
        if cfg.batch_size % n_dev:
            raise ValueError(
                f"lookup_mode=route needs batch_size divisible by "
                f"{n_dev} devices, got {cfg.batch_size}"
            )
        return "route"
    return "route" if cfg.batch_size % n_dev == 0 else "replicate"


def route_slots(cfg: Config, n_shards: int, mesh_data: int) -> int:
    """K: route-mode bucket slots per (device, peer-shard) pair.

    Single source of ShardedStep.route_k's sizing formula, shared with the
    preflight HBM estimator (train.py::estimate_hbm_bytes) so the warning
    models the same buffers the step actually allocates."""
    n_local = cfg.batch_size // (mesh_data * n_shards) * max(1, cfg.max_nnz)
    k = int(n_local / n_shards * cfg.route_capacity)
    return max(8, min(n_local, -(-k // 8) * 8))


def resolves_to_route(cfg: Config) -> bool:
    """Whether this config's mesh would run routed lookups (pure config
    twin of _resolve_lookup_mode, for preflight estimation)."""
    m = max(1, cfg.mesh_model)
    if m == 1 or cfg.lookup_mode == "replicate":
        return False
    n_dev = max(1, cfg.mesh_data) * m
    return cfg.lookup_mode == "route" or cfg.batch_size % n_dev == 0


class ShardedStep:
    """Jitted sharded train/eval steps for one model config on one mesh."""

    def __init__(self, cfg: Config, mesh: Mesh, state: ModelState):
        self.cfg = cfg
        self.mesh = mesh
        self.params = FtrlParams(cfg.w_alpha, cfg.w_beta, cfg.w_l1, cfg.w_l2)
        self.n_feats = cfg.n_feats
        self.n_shards = mesh.shape["model"]
        self.rows_local = state.lin_n.shape[0] // self.n_shards
        self.mode = _resolve_lookup_mode(cfg, mesh)
        if self.mode == "route":
            self._batch_axes = ("data", "model")
            self.route_k = route_slots(cfg, self.n_shards, mesh.shape["data"])
        else:
            self._batch_axes = ("data",)
            self.route_k = 0

        if mesh.shape["data"] > 1:
            width = max(1, cfg.row_width)
            acc_bytes = 2 * self.rows_local * width * 4
            if acc_bytes > (256 << 20):
                import warnings

                warnings.warn(
                    f"mesh_data={mesh.shape['data']} replicates each table "
                    f"shard and all-reduces a {acc_bytes / 1e9:.1f} GB dense "
                    f"accumulator over the data axis EVERY step — an "
                    f"O(rows/mesh_model) ICI leg that dominates at this "
                    f"table size.  Scale with mesh_data=1, mesh_model=N, "
                    f"lookup_mode=route instead (no O(table) collectives; "
                    f"see tools/scaling_model.py)."
                )
        sspecs = state_pspecs(state)
        bspecs = Batch(*batch_pspecs(self._batch_axes))
        of_spec = P() if self.mode == "route" else None
        train_out_specs = TrainOut(
            sspecs, P(self._batch_axes), P(), P(), of_spec
        )
        self.train_step = jax.jit(
            shard_map(
                self._train_step,
                mesh=mesh,
                in_specs=(sspecs, bspecs),
                out_specs=train_out_specs,
                check_vma=False,
            ),
            donate_argnums=0,
        )
        eval_out_specs = (P(), P(), P(self._batch_axes), of_spec)
        self.eval_step = jax.jit(
            shard_map(
                self._eval_step,
                mesh=mesh,
                in_specs=(sspecs, bspecs),
                out_specs=eval_out_specs,
                check_vma=False,
            )
        )
        # kept for lazily-built variants (build_cached_steps)
        self._sspecs = sspecs
        self._train_out_specs = train_out_specs
        self._eval_out_specs = eval_out_specs

        # Multi-step variants: lax.scan over a [S, ...] stack of batches in
        # ONE dispatch — amortizes host->device dispatch latency (the analogue
        # of the reference's 20000-line consumer chunks, pc_task.h:34).
        multi_bspecs = Batch(*(P(None, *s) for s in batch_pspecs(self._batch_axes)))
        self.train_multi = jax.jit(
            shard_map(
                self._train_multi,
                mesh=mesh,
                in_specs=(sspecs, multi_bspecs),
                out_specs=(sspecs, P(), P(), of_spec),
                check_vma=False,
            ),
            donate_argnums=0,
        )
        self.eval_multi = jax.jit(
            shard_map(
                self._eval_multi,
                mesh=mesh,
                in_specs=(sspecs, multi_bspecs),
                out_specs=(P(), P(), P(), P(), of_spec),
                check_vma=False,
            )
        )

    # ---- device-resident cached datasets (Config.device_cache) ----
    def build_cached_steps(self, layout: str = "replicate") -> None:
        """Jitted steps over a device-resident offline dataset (fields,
        feats, vals, y — inert pad rows, see Trainer._ensure_device_cache);
        each step receives only the [B] int32 permutation row, sharded over
        the batch axes, and gathers its local batch slice on device before
        running the ordinary sharded step body (the device form of the
        reference's in-memory offline task, src/task/ftrl_offline.cpp:21-42).

        Two layouts (Config.device_cache_layout):
        * "replicate" — every device holds the full dataset (+ one inert
          tail row); indices are GLOBAL, so batches bit-match the streamed
          path's global shuffle.  n_real is a replicated scalar.
        * "shard" — each device holds a contiguous 1/D slice padded to
          rows_loc (= max slice + 1 inert row); indices are LOCAL to the
          device's slice and n_real arrives as a [D] array sharded over the
          batch axes (each device reads its own real count).  1/D the HBM,
          per-slice shuffle — the cached twin of the multi-host streamed
          semantics (each process owns a byte-range slice).

        One dispatch per step, donated state; per-step [B] row upload
        (see train.py::_gather_train_one_impl)."""
        from ftrl_ffm_tpu.models.base import take_cached

        rep = layout == "replicate"
        if hasattr(self, "gather_train_one" if rep else "gather_train_one_shard"):
            return
        dim0 = P() if rep else P(self._batch_axes)
        ds_specs = (dim0, dim0, dim0, dim0)
        idx_spec = P(self._batch_axes)
        n_spec = P() if rep else P(self._batch_axes)

        def tr(state, ds, ix, n_real):
            return self._train_step(state, take_cached(ds, ix, n_real))

        train_jit = jax.jit(
            shard_map(
                tr,
                mesh=self.mesh,
                in_specs=(self._sspecs, ds_specs, idx_spec, n_spec),
                out_specs=self._train_out_specs,
                check_vma=False,
            ),
            donate_argnums=0,
        )
        if rep:
            self.gather_train_one = train_jit

            def ev(state, ds, ix, n_real):
                return self._eval_step(state, take_cached(ds, ix, n_real))

            self.gather_eval_one = jax.jit(
                shard_map(
                    ev,
                    mesh=self.mesh,
                    in_specs=(self._sspecs, ds_specs, idx_spec, n_spec),
                    out_specs=self._eval_out_specs,
                    check_vma=False,
                )
            )
        else:
            self.gather_train_one_shard = train_jit

            # shard-local indices can't be mapped to global y/sample_w
            # outside the mesh, so the AUC buckets reduce inside the step
            from ftrl_ffm_tpu.metrics import AUC_BINS, StreamingAUC

            def ev_shard(state, ds, ix, n_real):
                b = widen_batch(take_cached(ds, ix, n_real))
                logits, overflow = self._eval_logits(state, b)
                per_loss = binary_logloss(logits, b.y) * b.sample_w
                loss_sum = jax.lax.psum(jnp.sum(per_loss), self._batch_axes)
                count = jax.lax.psum(jnp.sum(b.sample_w), self._batch_axes)
                pos, neg = StreamingAUC.bucket_counts(
                    logits, b.y, b.sample_w, AUC_BINS
                )
                pos = jax.lax.psum(pos, self._batch_axes)
                neg = jax.lax.psum(neg, self._batch_axes)
                return loss_sum, count, pos, neg, overflow

            of_spec = self._eval_out_specs[-1]
            self.gather_eval_auc_shard = jax.jit(
                shard_map(
                    ev_shard,
                    mesh=self.mesh,
                    in_specs=(self._sspecs, ds_specs, idx_spec, n_spec),
                    out_specs=(P(), P(), P(), P(), of_spec),
                    check_vma=False,
                )
            )

    # ---- physical ids ----
    def _phys_ids(self, feats: jax.Array) -> jax.Array:
        """Flat physical row ids for the local batch shard (sentinel = Rp)."""
        return interleave_ids(
            feats.reshape(-1), self.n_shards, self.rows_local, self.n_feats
        )

    # ---- replicate-mode table access (runs on per-device local views) ----
    def _local_lookup_mask(self, ids_phys: jax.Array):
        """(local_ids, in_shard_mask) for this device's physical row block."""
        shard = jax.lax.axis_index("model")
        offset = shard * self.rows_local
        mask = (ids_phys >= offset) & (ids_phys < offset + self.rows_local)
        lid = jnp.clip(ids_phys - offset, 0, self.rows_local - 1)
        return lid, mask

    def _lookup_linear(self, lin_w, ids_phys):
        """w rows for `ids`, assembled across table shards via psum("model").

        One gather per table — w is stored, like the reference's lin_w read in
        its hot loop (reference: src/model/ftrl_model.cpp:44-50)."""
        lid, mask = self._local_lookup_mask(ids_phys)
        w = jnp.where(mask, jnp.take(lin_w, lid), 0.0)
        return jax.lax.psum(w, "model")

    def _lookup_vec(self, vec_w, ids_phys):
        lid, mask = self._local_lookup_mask(ids_phys)
        w = jnp.where(
            mask[..., None],
            jnp.take(vec_w, lid, axis=0),
            jnp.zeros((), vec_w.dtype),
        )
        # each element is owned by exactly one shard (others contribute 0),
        # so a bf16 psum is exact; compute continues in f32
        return jax.lax.psum(w, "model").astype(jnp.float32)

    # ---- route-mode machinery ----
    def _route(self, ids_phys: jax.Array) -> Routing:
        """Bucket local physical ids by owner shard, exchange over "model".

        Routes UNIQUE ids: every occurrence of an id shares ONE send slot
        (rank = the id's index among this device's distinct ids per owner,
        computed from one sorted pass).  The payload scatter
        (_table_update_routed's .at[slot].add) aggregates duplicates into
        the slot before the wire, and the returned row is read by all its
        occurrences — so a hot id consumes one capacity slot regardless of
        multiplicity, and heavy-tailed (Zipf) id skew CANNOT overflow the
        buckets: overflow now requires > route_k DISTINCT ids hashing to
        one peer, which modulo interleaving makes near-impossible at the
        default route_capacity (only adversarial id sets ≡ r mod M reach
        it; those are counted, warned, and raised under
        Config.route_overflow_policy="error").  This matches the
        reference's unconditional per-occurrence updates
        (src/model/ftrl_model.cpp:66-77) on any realistic data, and beats
        the occurrence-slot form on traffic (duplicates collapse)."""
        m, rl, k = self.n_shards, self.rows_local, self.route_k
        n = ids_phys.shape[0]
        owner = ids_phys // rl          # sentinel Rp -> m (invalid)
        local = (ids_phys % rl).astype(jnp.int32)
        order = jnp.argsort(ids_phys)   # id-sorted => owner-sorted too
        sid = jnp.take(ids_phys, order)
        sowner = jnp.take(owner, order)
        one = jnp.ones((1,), bool)
        id_start = jnp.concatenate([one, sid[1:] != sid[:-1]])
        owner_start = jnp.concatenate([one, sowner[1:] != sowner[:-1]])
        uniq_sofar = jnp.cumsum(id_start.astype(jnp.int32))  # 1-based
        # distinct ids preceding this owner's first run, propagated by
        # cummax (uniq_sofar - 1 is nondecreasing; owner_start ⊆ id_start)
        base = jax.lax.cummax(jnp.where(owner_start, uniq_sofar - 1, 0))
        rank_sorted = uniq_sofar - 1 - base  # unique-rank within owner
        valid_sorted = (sowner < m) & (rank_sorted < k)
        slot_sorted = jnp.where(
            valid_sorted, sowner.astype(jnp.int32) * k + rank_sorted, m * k
        )
        slot = jnp.zeros((n,), jnp.int32).at[order].set(slot_sorted)
        valid = slot < m * k
        send = (
            jnp.full((m * k,), rl, jnp.int32)
            .at[slot]
            .set(local, mode="drop")  # duplicates write the same local id
        )
        recv = jax.lax.all_to_all(
            send.reshape(m, k), "model", 0, 0, tiled=True
        ).reshape(-1)
        overflow = jnp.sum(((sowner < m) & ~valid_sorted).astype(jnp.int32))
        return Routing(slot=slot, valid=valid, recv=recv, overflow=overflow)

    def _routed_rows(self, tab, rt: Routing):
        """Rows of the model-sharded table for this device's occurrences.

        Owner-side gather + all_to_all return; per-device traffic is
        O(nnz_local * width) regardless of shard count."""
        m, rl, k = self.n_shards, self.rows_local, self.route_k
        one_d = tab.ndim == 1
        rows = jnp.take(tab, rt.recv, axis=0, mode="clip")  # [M*K(, E)]
        invalid = rt.recv >= rl
        rows = jnp.where(invalid if one_d else invalid[:, None], 0, rows)
        shape = (m, k) if one_d else (m, k, tab.shape[-1])
        back = jax.lax.all_to_all(
            rows.reshape(shape), "model", 0, 0, tiled=True
        ).reshape((m * k,) if one_d else (m * k, tab.shape[-1]))
        out = jnp.take(back, jnp.minimum(rt.slot, m * k - 1), axis=0)
        inv2 = ~rt.valid
        out = jnp.where(inv2 if one_d else inv2[:, None], 0, out)
        return out.astype(jnp.float32)

    def _table_update_routed(self, n_tab, z_tab, w_tab, rt: Routing, gg2):
        """Route combined payloads to owners, accumulate, closed-form pass.

        Huge shards on a (1, N) mesh take the in-place form (z-scatter +
        single accumulator + in-place closed-form pass,
        ftrl.py::dense_ftrl_update_inplace): the dense [rows_local, 2D]
        accumulator would not fit device memory at production shard sizes
        (e.g. R=100M over 64 devices -> 7.7 GB), and with mesh_data == 1 there is
        no cross-replica psum to forbid in-place mutation."""
        m, rl, k = self.n_shards, self.rows_local, self.route_k
        d2 = gg2.shape[-1]
        send = jnp.zeros((m * k, d2), gg2.dtype).at[rt.slot].add(gg2, mode="drop")
        pay = jax.lax.all_to_all(
            send.reshape(m, k, d2), "model", 0, 0, tiled=True
        ).reshape(m * k, d2)
        if n_tab.ndim > 1 and self.mesh.shape["data"] == 1:
            from ftrl_ffm_tpu.ftrl import (
                dense_ftrl_update_inplace,
                select_update_kind,
            )

            d = d2 // 2
            kind = select_update_kind(
                rl, d, pay.shape[0], self.cfg.update_mode
            )
            if kind in ("inplace", "sparse2"):
                # sparse2-regime shards (> the in-place single-accumulator
                # budget) also take this form: it allocates ONE [rl, D]
                # accumulator — half the dense [rl, 2D] fall-through below,
                # which is exactly the footprint the largest shards cannot
                # afford.
                # rt.recv's empty-slot sentinel is rl == shape[0]: dropped
                return dense_ftrl_update_inplace(
                    n_tab, z_tab, w_tab, rt.recv,
                    pay[:, :d], pay[:, d:], self.params,
                )
        acc = jnp.zeros((rl, d2), gg2.dtype).at[rt.recv].add(pay, mode="drop")
        acc = jax.lax.psum(acc, "data")
        if n_tab.ndim == 1:
            sum_g, sum_g2 = acc[:, 0], acc[:, 1]
        else:
            d = d2 // 2
            sum_g, sum_g2 = acc[:, :d], acc[:, d:]
        w_f32 = w_tab.astype(n_tab.dtype)
        new_n, new_z = ftrl_accumulate(n_tab, z_tab, w_f32, sum_g, sum_g2, self.params)
        new_w = jnp.where(new_n > UNTOUCHED_N, ftrl_weights(new_n, new_z, self.params), w_f32)
        return new_n, new_z, new_w.astype(w_tab.dtype)

    # ---- shared logits plumbing ----
    @property
    def _lin_lane(self) -> int:
        """Dead lane of the padded FFM factor row that mirrors the linear
        table (see models/ffm.py::FFM._lin_lane).  In the sharded step the
        mirror removes the entire routed/replicated LINEAR lookup: the
        gathered factor rows already carry the linear weight in this lane,
        and the payload fold keeps the mirror true under the same psum /
        all_to_all aggregation as the canonical linear tables."""
        cfg = self.cfg
        if cfg.model_type == "FFM" and cfg.field_pad > cfg.n_fields:
            return cfg.n_fields
        return -1

    def _w_lin(self, state, v, rt, ids_phys, shape):
        """[b_local, F] linear weights: read from the mirrored lane of the
        already-gathered rows when enabled (f32 tables only — a bf16
        mirror would quantize the linear term), else the canonical
        routed/replicated lin_w lookup."""
        if (
            self._lin_lane >= 0
            and v is not None
            and self.cfg.table_dtype == "float32"
        ):
            return v[:, self._lin_lane].reshape(shape)
        if rt is not None:
            return self._routed_rows(state.lin_w, rt).reshape(shape)
        return self._lookup_linear(state.lin_w, ids_phys.reshape(shape))

    def _use_pallas(self) -> bool:
        from ftrl_ffm_tpu.ops.ffm_pallas import resolve_use_pallas

        return self.cfg.model_type == "FFM" and resolve_use_pallas(
            self.cfg.use_pallas
        )

    def _model_logits_gg2(self, batch: Batch, lin, v, train: bool):
        """(logits, combined payload or None) from gathered rows.

        FFM on the GPU routes through the fused kernel (ops/ffm_pallas.py)
        — pallas_call composes with shard_map since it is per-device local
        compute; collectives stay outside the kernel."""
        cfg = self.cfg
        b_local = batch.feats.shape[0]
        if cfg.model_type == "LR":
            return lin, None
        if cfg.model_type == "FFM" and self._use_pallas():
            if train:
                from ftrl_ffm_tpu.ops.ffm_pallas import ffm_fused_logits_grads

                return ffm_fused_logits_grads(
                    v, batch.fields, batch.vals, lin, batch.y, batch.sample_w,
                    cfg.field_pad, cfg.n_factors, combined_out=True,
                    # payload fold maintains the dead-lane linear mirror
                    # (lin itself arrives precomputed, so lin_lane stays off)
                    aug_lane=self._lin_lane,
                )
            from ftrl_ffm_tpu.ops.ffm_pallas import ffm_fused_logits

            logits = ffm_fused_logits(
                v, batch.fields, batch.vals, lin, cfg.field_pad, cfg.n_factors
            )
            return logits, None
        v3 = v.reshape(b_local, -1, v.shape[-1])
        if cfg.model_type == "FM":
            logits, dv = fm_logits_and_grads(v3, batch.vals, lin)
        else:
            logits, dv = ffm_logits_and_grads(
                v3, batch.fields, batch.vals, lin,
                cfg.field_pad, cfg.n_factors, compute_grads=train,
            )
        if not train or dv is None:
            return logits, None
        gs = (jax.nn.sigmoid(logits) - batch.y) * batch.sample_w
        g = (gs[:, None, None] * dv).reshape(dv.shape[0] * dv.shape[1], -1)
        lane = self._lin_lane
        if lane >= 0 and cfg.model_type == "FFM":
            # maintain the dead-lane linear mirror on the XLA path too
            g_lin = (gs[:, None] * batch.vals).reshape(-1)
            g = jnp.where(jnp.arange(g.shape[-1]) == lane, g_lin[:, None], g)
        return logits, jnp.concatenate([g, g * g], axis=-1)

    # ---- replicate-mode dense table update ----
    def _table_update(self, n_tab, z_tab, w_tab, ids_phys, gg2):
        """Global FTRL step on this device's table shard, combined payload
        gg2 [nnz_local, 2*D] (g in lanes [:D], g^2 in [D:]).

        Dense mode: local scatter-add into a table-shaped accumulator +
        psum("data") (the classic dense-grad all-reduce) + fused closed-form
        pass.  Sparse mode (huge table shards): all_gather the (id, gg2)
        stream over "data" so each shard sees the whole global batch, then
        update touched local rows only — O(global nnz) temps instead of
        O(R_local)."""
        tab_rows = self.rows_local
        row_width = n_tab.shape[1] if n_tab.ndim > 1 else 1
        global_nnz = ids_phys.shape[0] * self.mesh.shape["data"]
        update = select_ftrl_update2(
            tab_rows, row_width, global_nnz, self.cfg.update_mode
        )
        if update is sparse_ftrl_update2:
            ids_g = jax.lax.all_gather(ids_phys, "data", axis=0, tiled=True)
            gg2_g = jax.lax.all_gather(gg2, "data", axis=0, tiled=True)
            lid, mask = self._local_lookup_mask(ids_g)
            lid = jnp.where(mask, lid, tab_rows)  # out-of-shard -> dropped
            return sparse_ftrl_update2(n_tab, z_tab, w_tab, lid, gg2_g, self.params)
        lid, mask = self._local_lookup_mask(ids_phys)
        lid = jnp.where(mask, lid, tab_rows)  # out-of-shard -> drop sentinel
        acc = jnp.zeros((tab_rows, gg2.shape[-1]), gg2.dtype).at[lid].add(
            gg2, mode="drop"
        )
        acc = jax.lax.psum(acc, "data")
        if n_tab.ndim == 1:
            sum_g, sum_g2 = acc[:, 0], acc[:, 1]
        else:
            d = gg2.shape[-1] // 2
            sum_g, sum_g2 = acc[:, :d], acc[:, d:]
        w_f32 = w_tab.astype(n_tab.dtype)
        new_n, new_z = ftrl_accumulate(n_tab, z_tab, w_f32, sum_g, sum_g2, self.params)
        new_w = jnp.where(new_n > UNTOUCHED_N, ftrl_weights(new_n, new_z, self.params), w_f32)
        return new_n, new_z, new_w.astype(w_tab.dtype)

    # ---- steps (bodies run per device under shard_map) ----
    def _train_step(self, state: ModelState, batch: Batch):
        p = self.params
        batch = widen_batch(batch)
        ids_phys = self._phys_ids(batch.feats)
        bias_w = ftrl_weights(state.bias_n, state.bias_z, p)

        rt = None
        if self.mode == "route":
            rt = self._route(ids_phys)
            jax.lax.cond(
                rt.overflow > 0,
                lambda o: jax.debug.print(
                    "ftrl_ffm_tpu WARNING: routed lookup overflow - {n} "
                    "occurrences dropped this step; raise route_capacity",
                    n=o,
                ),
                lambda o: None,
                rt.overflow,
            )
            v = (
                self._routed_rows(state.vec_w, rt)
                if state.vec_w is not None
                else None
            )
        else:
            v = (
                self._lookup_vec(state.vec_w, ids_phys)
                if state.vec_w is not None
                else None
            )
        # mirrored lane spares the second routed lookup (its own
        # all_to_all pair) for padded FFM — see _w_lin
        w_lin = self._w_lin(state, v, rt, ids_phys, batch.feats.shape)

        lin = linear_logits(w_lin, batch.vals, bias_w)
        logits, gg2_vec = self._model_logits_gg2(batch, lin, v, train=True)
        gs = (jax.nn.sigmoid(logits) - batch.y) * batch.sample_w  # [b_local]

        # Bias: global grad sums over the batch axes, replicated update.
        sum_g = jax.lax.psum(jnp.sum(gs), self._batch_axes)
        sum_g2 = jax.lax.psum(jnp.sum(gs * gs), self._batch_axes)
        bias_n, bias_z = ftrl_accumulate(
            state.bias_n, state.bias_z, bias_w, sum_g, sum_g2, p
        )

        g_lin = (gs[:, None] * batch.vals).reshape(-1)
        gg2_lin = jnp.stack([g_lin, g_lin * g_lin], axis=-1)  # [nnz, 2]
        if self.mode == "route":
            lin_n, lin_z, lin_w = self._table_update_routed(
                state.lin_n, state.lin_z, state.lin_w, rt, gg2_lin
            )
        else:
            lin_n, lin_z, lin_w = self._table_update(
                state.lin_n, state.lin_z, state.lin_w, ids_phys, gg2_lin
            )

        vec_n, vec_z, vec_w = state.vec_n, state.vec_z, state.vec_w
        if gg2_vec is not None:
            if self.mode == "route":
                vec_n, vec_z, vec_w = self._table_update_routed(
                    state.vec_n, state.vec_z, state.vec_w, rt, gg2_vec
                )
            else:
                vec_n, vec_z, vec_w = self._table_update(
                    state.vec_n, state.vec_z, state.vec_w, ids_phys, gg2_vec
                )

        count = jax.lax.psum(jnp.sum(batch.sample_w), self._batch_axes)
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
        loss_sum = jax.lax.psum(jnp.sum(per_loss), self._batch_axes)
        overflow = (
            jax.lax.psum(rt.overflow, self._batch_axes) if rt is not None else None
        )
        return TrainOut(new_state, logits, loss_sum, count, overflow)

    def _eval_logits(self, state: ModelState, batch: Batch):
        """(logits, route_overflow or None) — the eval path must be as loud
        about capacity drops as the train path: dropped occurrences read 0
        weights, so losses/AUC/predictions would silently miss features."""
        ids_phys = self._phys_ids(batch.feats)
        bias_w = ftrl_weights(state.bias_n, state.bias_z, self.params)
        rt = None
        if self.mode == "route":
            rt = self._route(ids_phys)
            jax.lax.cond(
                rt.overflow > 0,
                lambda o: jax.debug.print(
                    "ftrl_ffm_tpu WARNING: routed lookup overflow during "
                    "eval/predict - {n} occurrences read zero weights; "
                    "raise route_capacity",
                    n=o,
                ),
                lambda o: None,
                rt.overflow,
            )
            v = (
                self._routed_rows(state.vec_w, rt)
                if state.vec_w is not None
                else None
            )
        else:
            v = (
                self._lookup_vec(state.vec_w, ids_phys)
                if state.vec_w is not None
                else None
            )
        w_lin = self._w_lin(state, v, rt, ids_phys, batch.feats.shape)
        lin = linear_logits(w_lin, batch.vals, bias_w)
        logits, _ = self._model_logits_gg2(batch, lin, v, train=False)
        overflow = (
            jax.lax.psum(rt.overflow, self._batch_axes) if rt is not None else None
        )
        return logits, overflow

    def _eval_step(self, state: ModelState, batch: Batch):
        batch = widen_batch(batch)
        logits, overflow = self._eval_logits(state, batch)
        per_loss = binary_logloss(logits, batch.y) * batch.sample_w
        loss_sum = jax.lax.psum(jnp.sum(per_loss), self._batch_axes)
        count = jax.lax.psum(jnp.sum(batch.sample_w), self._batch_axes)
        return loss_sum, count, logits, overflow

    # ---- multi-step (scan) bodies ----
    def _train_multi(self, state: ModelState, batches: Batch):
        route = self.mode == "route"

        def body(st, b):
            out = self._train_step(st, b)
            of = out.route_overflow if route else jnp.zeros((), jnp.int32)
            return out.state, (out.loss_sum, out.count, of)

        state, (ls, ct, of) = jax.lax.scan(body, state, batches)
        return state, jnp.sum(ls), jnp.sum(ct), jnp.sum(of) if route else None

    def _eval_multi(self, state: ModelState, batches: Batch):
        from ftrl_ffm_tpu.metrics import AUC_BINS as bins, StreamingAUC

        route = self.mode == "route"

        def body(carry, b):
            ls0, ct0, pos0, neg0, of0 = carry
            b = widen_batch(b)
            logits, overflow = self._eval_logits(state, b)
            per_loss = binary_logloss(logits, b.y) * b.sample_w
            pos, neg = StreamingAUC.bucket_counts(logits, b.y, b.sample_w, bins)
            of = of0 + overflow if route else of0
            return (
                ls0 + jnp.sum(per_loss),
                ct0 + jnp.sum(b.sample_w),
                pos0 + pos,
                neg0 + neg,
                of,
            ), None

        init = (
            jnp.zeros((), jnp.float32),
            jnp.zeros((), jnp.float32),
            jnp.zeros((bins,), jnp.float32),
            jnp.zeros((bins,), jnp.float32),
            jnp.zeros((), jnp.int32),
        )
        (ls, ct, pos, neg, of), _ = jax.lax.scan(body, init, batches)
        ax = self._batch_axes
        return (
            jax.lax.psum(ls, ax),
            jax.lax.psum(ct, ax),
            jax.lax.psum(pos, ax),
            jax.lax.psum(neg, ax),
            # psum'd per batch already inside _eval_logits
            of if route else None,
        )

    # ---- host-side batch placement ----
    def _put(self, a, spec, batch_dim=0):
        """Place one host array: device_put single-process, or assemble the
        global array from this process's local slice (multi-host — each
        process feeds its byte-range shard of every global batch).
        Replicated leaves (spec without a batch axis, e.g. feats_base) are
        identical on every process and placed as-is."""
        if a is None:
            return None
        sharding = NamedSharding(self.mesh, spec)
        if jax.process_count() == 1:
            return jax.device_put(a, sharding)
        sharded = len(spec) > batch_dim and spec[batch_dim] is not None
        if not sharded:
            return jax.make_array_from_process_local_data(sharding, a, a.shape)
        gshape = list(a.shape)
        gshape[batch_dim] *= jax.process_count()
        return jax.make_array_from_process_local_data(sharding, a, tuple(gshape))

    def _with_base(self, arrays, stacked: bool):
        """shard_map in_specs were built with 6 leaves; substitute an inert
        feats_base (ignored by widen_batch for int32 feats) when absent so
        the batch pytree structure never changes."""
        import numpy as np

        if len(arrays) >= 6 and arrays[5] is not None:
            return arrays
        # sized from FEATS (a real feats_base is [max_nnz + 1]): fields may
        # be the zero-width LR/FM upload, and a mismatched dummy aval would
        # force a step recompile when the real base appears later
        f = arrays[1].shape[-1]
        dummy = (
            np.zeros((arrays[1].shape[0], f + 1), np.int32)
            if stacked
            else np.zeros(f + 1, np.int32)
        )
        return (*arrays[:5], dummy)

    def place_batch(self, arrays) -> Batch:
        specs = batch_pspecs(self._batch_axes)
        arrays = self._with_base(arrays, stacked=False)
        return Batch(*(self._put(a, s) for a, s in zip(arrays, specs)))

    def place_batch_multi(self, arrays) -> Batch:
        """Place a [S, ...]-stacked batch group (leading dim unsharded)."""
        specs = [P(None, *s) for s in batch_pspecs(self._batch_axes)]
        arrays = self._with_base(arrays, stacked=True)
        return Batch(
            *(self._put(a, s, batch_dim=1) for a, s in zip(arrays, specs))
        )


def batch_pspecs(batch_axes=("data",)) -> tuple:
    """Batch arrays row-sharded over `batch_axes`:
    (fields, feats, vals, y, sample_w, feats_base) — feats_base (the
    compact-transfer id bases, models/base.py::Batch) is replicated."""
    two_d = P(batch_axes, None)
    one_d = P(batch_axes)
    return (two_d, two_d, two_d, one_d, one_d, P(None))


def state_pspecs(state: ModelState) -> ModelState:
    from ftrl_ffm_tpu.parallel.mesh import state_pspecs as _sp

    return _sp(state)
