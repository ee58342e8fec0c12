"""Field-aware factorization machine with FTRL (reference: src/model/ffm.cpp).

The reference stores each feature row as n_fields * n_factors weights, slot
(field, k) = field * n_factors + k (src/model/ffm.cpp:17-28, :63-65).
Internally rows are **factor-major and lane-padded**: slot (k, c) =
k * field_pad + c with field_pad >= n_fields (Config.field_pad; ops/layout.py
converts at import/export).  Dead lane (0, n_fields) mirrors the LINEAR
table — every update path feeds it the linear gradient, so the forward pass
reads w_lin from the factor rows it already gathers and the separate linear
gather disappears (see _lin_lane).  The pairwise m<n loop becomes a
field-bucketed contraction (see ops/interactions.py::ffm_logits_and_grads).

Note: the reference's v_sif2 update uses `v_gif2 * v_gif1` where the FTRL
recurrence calls for `v_gif2 * v_gif2` (src/model/ffm.cpp:118) — an apparent
typo we deliberately do NOT reproduce.
"""

from __future__ import annotations

import jax.numpy as jnp

from ftrl_ffm_tpu.models.base import Batch, Model, ModelState
from ftrl_ffm_tpu.ops.interactions import ffm_logits_and_grads, linear_logits


class FFM(Model):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.n_fields = cfg.n_fields
        self.n_factors = cfg.n_factors
        # the interaction math runs over field_pad >= n_fields fields; the
        # extra fields never occur, so their slots are inert (Config.field_pad)
        self.field_pad = cfg.field_pad

    def _export_vec_layout(self, vec_w):
        from ftrl_ffm_tpu.ops.layout import kmajor_to_reference

        return kmajor_to_reference(
            vec_w, self.n_fields, self.n_factors, self.field_pad
        )

    def _import_vec_layout(self, vec_w):
        from ftrl_ffm_tpu.ops.layout import reference_to_kmajor

        return reference_to_kmajor(
            vec_w, self.n_fields, self.n_factors, self.field_pad
        )

    def _use_pallas(self) -> bool:
        from ftrl_ffm_tpu.ops.ffm_pallas import resolve_use_pallas

        return resolve_use_pallas(self.cfg.use_pallas)

    def _emits_combined(self) -> bool:
        return self._use_pallas()

    def _emits_aug_combined(self) -> bool:
        return self._use_pallas()

    def _train_grads(
        self,
        state: ModelState,
        batch: Batch,
        split: bool,
        payload_dtype=None,
        aug: bool = False,
    ):
        """Fused kernel path on the GPU: one pass per sample computes the
        logit and the FTRL payload, with no [B, F, C*K] intermediates in
        device memory and no concat (the kernel writes the combined
        [B*F, 2E] layout, or separate g/g2 for the huge-table in-place
        update, directly; payload_dtype bf16 halves its write and the
        scatter's read bytes)."""
        if not self._use_pallas():
            return super()._train_grads(state, batch, split, payload_dtype)
        from ftrl_ffm_tpu.ops.ffm_pallas import ffm_fused_logits_grads

        lane = self._lin_lane()
        # flat [B*F, E] gather: single 2-D row-major stream into the kernel
        v = self._gather_vec(state, batch.feats.reshape(-1))
        # mirrored linear weights read from the rows just gathered: no
        # separate linear gather
        w = self._w_lin_from_rows(state, v, batch, self._lin_read_lane())
        lin = linear_logits(w, batch.vals, self.bias_weight(state))
        do_aug = aug and not split and lane >= 0
        logits, *payload = ffm_fused_logits_grads(
            v,
            batch.fields,
            batch.vals,
            lin,
            batch.y,
            batch.sample_w,
            self.field_pad,
            self.n_factors,
            combined_out=not split,
            out_dtype=payload_dtype or jnp.float32,
            # linear grad rides in dead lane (k=0, c=n_fields) of the
            # padded factor row (see Config.field_pad); the fold applies on
            # split payloads too so every update path maintains the mirror
            aug_lane=lane,
        )
        return logits, tuple(payload), do_aug

    def _lin_lane(self) -> int:
        """Dead lane (k=0, c=n_fields) that mirrors the linear table when
        the factor row is padded (Config.field_pad).  Every FFM update
        path feeds this lane the linear gradient, so the mirror holds at
        every step boundary and the forward pass reads the linear weight
        from the rows it already gathers — the separate [B, F] linear
        gather (same descriptor count as the big row gather) disappears
        from train AND serving."""
        return self.n_fields if self.field_pad > self.n_fields else -1

    def _lin_read_lane(self) -> int:
        """Lane the FORWARD pass reads w_lin from: the mirror lane, but
        only while the factor table is f32 — under table_dtype=bfloat16
        the mirror holds bf16-rounded linear weights, and silently
        quantizing the linear term would regress numerics vs the
        always-f32 lin_w gather (which stays exact).  The mirror itself
        is still maintained either way."""
        lane = self._lin_lane()
        return lane if self.cfg.table_dtype == "float32" else -1

    def _w_lin_from_rows(self, state, v, batch: Batch, lane: int):
        """[B, F] linear weights: mirrored lane of the gathered rows when
        enabled, else the canonical lin_w gather."""
        if lane >= 0:
            return v[:, lane].reshape(batch.feats.shape)
        return self._gather_linear(state, batch.feats)

    def _logits_and_grads(self, state: ModelState, batch: Batch, train: bool):
        read_lane = self._lin_read_lane()
        if not train and self._use_pallas():
            # inference-only fused kernel: the serving/eval hot path
            from ftrl_ffm_tpu.ops.ffm_pallas import ffm_fused_logits

            v = self._gather_vec(state, batch.feats.reshape(-1))
            w = self._w_lin_from_rows(state, v, batch, read_lane)
            lin = linear_logits(w, batch.vals, self.bias_weight(state))
            logits = ffm_fused_logits(
                v, batch.fields, batch.vals, lin, self.field_pad,
                self.n_factors,
            )
            return logits, None
        if read_lane >= 0:
            lin = jnp.broadcast_to(self.bias_weight(state), batch.y.shape)
        else:
            w = self._gather_linear(state, batch.feats)
            lin = linear_logits(w, batch.vals, self.bias_weight(state))
        v = self._gather_vec(state, batch.feats)  # [B, F, C'*K]
        logits, dlogit_dv = ffm_logits_and_grads(
            v,
            batch.fields,
            batch.vals,
            lin,
            self.field_pad,
            self.n_factors,
            compute_grads=train,
            lin_lane=read_lane,
            grad_lane=self._lin_lane(),
        )
        return logits, dlogit_dv

    def _lin_mirror_maintained(self) -> bool:
        # Both payload producers fold g_lin into the dead lane
        # (ffm_pallas aug_lane / interactions grad_lane), and the forward
        # reads w_lin from the mirror whenever _lin_read_lane() >= 0 — so
        # with f32 tables the mirror is a complete linear-table replica.
        return self._lin_read_lane() >= 0

    def sync_lin_from_mirror(self, state: ModelState) -> ModelState:
        """lin_(n,z,w) := factor tables' dead mirror lane.

        Exact: the mirror lane starts at the linear init (0, see
        Model.init's dead-lane zeroing) and accumulates the identical
        (g_lin, g_lin^2) stream through every update path, so its closed
        form equals the canonical linear tables'.  Cost: one strided
        column read per table — boundary-only (checkpoints/exports), never
        per-step."""
        lane = self._lin_read_lane()
        if lane < 0 or state.vec_n is None:
            return state
        n = state.lin_n.shape[0]
        return state._replace(
            lin_n=state.vec_n[:n, lane],
            lin_z=state.vec_z[:n, lane],
            lin_w=state.vec_w[:n, lane].astype(state.lin_w.dtype),
        )

    def init_from_weights(self, bias, lin_w, vec_w=None) -> ModelState:
        """Restore the dead-lane linear mirror on warm starts: reference
        blobs know nothing about the padded layout, so after the base
        import the linear weight/z are copied into lane (0, n_fields) of
        the factor tables (see _lin_lane)."""
        state = super().init_from_weights(bias, lin_w, vec_w)
        lane = self._lin_lane()
        if lane < 0 or state.vec_w is None:
            return state
        vw = state.vec_w.at[:, lane].set(
            state.lin_w.astype(state.vec_w.dtype)
        )
        vz = state.vec_z.at[:, lane].set(state.lin_z)
        vn = state.vec_n.at[:, lane].set(state.lin_n)
        return state._replace(vec_w=vw, vec_z=vz, vec_n=vn)
