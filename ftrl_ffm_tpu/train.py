"""Training orchestration: online (streaming) and offline (in-memory) modes.

Mirrors the reference's task layer (src/task/ftrl_online.cpp:42-67,
src/task/ftrl_offline.cpp:44-61): per-epoch train pass with running train
log-loss computed from the pre-update training logits, followed by an eval
pass, both printed in the reference's format.  The concurrency runtime
(producer/consumer threads, thread pool) is replaced by a host prefetch
thread feeding jitted device steps.
"""

from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ftrl_ffm_tpu.config import Config, detect_file_type
from ftrl_ffm_tpu.data.loader import batch_iterator, load_file
from ftrl_ffm_tpu.data.parser import sniff_max_nnz
from ftrl_ffm_tpu.data.stream import StreamReader
from ftrl_ffm_tpu.metrics import (
    AUC_BINS,
    LossAccumulator,
    StreamingAUC,
    exact_auc,
    kahan_add,
)
from ftrl_ffm_tpu.models import Batch, make_model
from ftrl_ffm_tpu.models.base import ModelState, take_cached


def _pack_bitplanes(a: np.ndarray, k: int) -> np.ndarray:
    """[..., F] small ints -> [..., k, ceil(F/8)] uint8: plane i holds bit i
    of each value, MSB-first-packed along F (np.packbits bit order — the
    device decode in models/base.py::widen_batch mirrors it).  k = 0 yields
    the zero-plane marker shape."""
    if k == 0:
        return np.zeros((*a.shape[:-1], 0, (a.shape[-1] + 7) // 8), np.uint8)
    planes = np.stack([(a >> i) & 1 for i in range(k)], axis=-2)
    return np.packbits(planes, axis=-1)


class _DevCache(NamedTuple):
    """A device-resident offline dataset (Config.device_cache).

    layout: "replicate" (full copy per device, global indices) or "shard"
    (contiguous 1/D slice per device, local indices).  n_loc/rows_loc/
    n_real_dev are shard-layout only: per-device real counts, padded rows
    per device (max slice + 1 inert), and the [D] real-count array sharded
    over the batch axes."""

    layout: str
    ds: tuple
    n: int
    n_loc: Optional[list]          # shard: THIS process's per-device counts
    rows_loc: Optional[int]        # shard: global max slice + 1 (inert row)
    n_real_dev: Optional[object]
    idx_sharding: Optional[object] = None  # multi-process: [B] row sharding
    src_stat: Optional[tuple] = None  # online train: (size, mtime_ns) at build
    compact: bool = False  # compact in-HBM leaf encodings (single-device;
                           # decoded after the gather — _decode_cached_batch)


_cache_enabled = False


def default_cache_dir() -> str:
    """The compile cache's fixed home inside the checkout (gitignored)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def enable_compilation_cache() -> None:
    """Persistent XLA compilation cache: step compiles are expensive (the
    whole fused train graph), identical across runs, and worth caching.
    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    directory is set here; otherwise the cache goes to default_cache_dir()
    (a fixed path: the path is part of what the cache is found by)."""
    global _cache_enabled
    if _cache_enabled:
        return
    _cache_enabled = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    path = default_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)


def device_memory_bytes(dev=None) -> Optional[int]:
    """Bytes JAX may allocate on `dev` (default: the first device), from
    memory_stats()["bytes_limit"].  None on the CPU, whose "device memory"
    is the host RAM that already holds the parsed arrays, so callers have
    nothing to gate on.  Any other device that reports no limit is an
    error: every budget below is a fraction of this number."""
    dev = dev if dev is not None else jax.devices()[0]
    if dev.platform == "cpu":
        return None
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"{dev.platform} device {dev.device_kind!r} reports no memory "
            "limit (memory_stats()['bytes_limit'])"
        )
    return int(limit)


def _validate_state_shapes(cfg: Config, state: ModelState) -> None:
    """Structural compatibility of a caller-provided state (resume,
    Trainer(state=...)): table shapes/dtypes must match what this config's
    model would build, with a named error instead of an opaque XLA shape
    failure deep inside the first step.  Complements the header check
    (io/checkpoint.py::validate_header_compat), which also catches
    same-shape/different-meaning mismatches like a field_pad change."""
    from ftrl_ffm_tpu.io.checkpoint import IncompatibleStateError

    r, w = cfg.n_feats, cfg.row_width
    issues = []
    if tuple(state.lin_n.shape) != (r,):
        issues.append(
            f"linear tables have {tuple(state.lin_n.shape)} rows, config "
            f"n_feats={r} expects ({r},)"
        )
    if w:
        if state.vec_n is None:
            issues.append(
                f"state has no factor tables, but model_type="
                f"{cfg.model_type} expects [{r}, {w}]"
            )
        else:
            if tuple(state.vec_n.shape) != (r, w):
                issues.append(
                    f"factor tables are {tuple(state.vec_n.shape)}, config "
                    f"(model_type={cfg.model_type}, n_feats={r}, "
                    f"n_fields={cfg.n_fields}, field_pad={cfg.field_pad}, "
                    f"n_factors={cfg.n_factors}) expects ({r}, {w})"
                )
            if str(state.vec_w.dtype) != cfg.table_dtype:
                issues.append(
                    f"factor weight table is {state.vec_w.dtype}, config "
                    f"table_dtype={cfg.table_dtype}"
                )
    elif state.vec_n is not None:
        issues.append(
            f"state has factor tables {tuple(state.vec_n.shape)}, but "
            f"model_type={cfg.model_type} has none"
        )
    if issues:
        raise IncompatibleStateError(
            "loaded state is incompatible with this config: "
            + "; ".join(issues)
            + ". Resume with the original flags, or retrain."
        )


def estimate_hbm_bytes(cfg: Config) -> dict:
    """Per-device HBM estimate for the train step: resident state, update
    working set, and (route mode) the all_to_all bucket buffers.

    Pure function of the config so its terms are unit-testable; the
    preflight warning (_warn_if_oversized) compares `total` against the
    device's reported limit.  Approximate by design — it models the big
    allocations (tables, accumulators, gathered rows, route buckets), not
    XLA's temp reuse."""
    from ftrl_ffm_tpu.ftrl import select_update_kind
    from ftrl_ffm_tpu.parallel.sharded import resolves_to_route, route_slots

    w = max(1, cfg.row_width)
    shards = max(1, cfg.mesh_model)
    mesh_data = max(1, cfg.mesh_data)
    r_loc = -(-cfg.n_feats // shards)
    nnz = cfg.batch_size * max(1, cfg.max_nnz)
    w_bytes = 2 if cfg.table_dtype == "bfloat16" else 4
    # resident: factor n/z (f32) + w (table_dtype) + three linear tables
    state_b = r_loc * w * (4 + 4 + w_bytes) + 3 * r_loc * 4
    routed = resolves_to_route(cfg)
    n_dev = shards * mesh_data
    nnz_loc = nnz if n_dev == 1 else nnz // n_dev
    # the table update aggregates M*K routed slots (route) or the local
    # occurrence stream (otherwise)
    mk = shards * route_slots(cfg, shards, mesh_data) if routed else 0
    kind = select_update_kind(r_loc, w, mk or nnz_loc, cfg.update_mode)
    if kind == "dense2":
        work_b = 2 * r_loc * w * 4
    else:  # inplace and the routed sparse2 fall-through both allocate one
        work_b = r_loc * w * 4  # table-shaped accumulator (sharded.py)
    # gathered rows + (g, g^2) payloads for the local batch slice
    work_b += 3 * nnz_loc * w * 4
    # route mode: send/recv bucket pairs for the lookup leg ([M*K, w] x2)
    # and the update leg ([M*K, 2w] x2) — sized by route_capacity, so an
    # oversized route config can OOM in the buckets before the tables do
    route_b = (2 * w + 2 * 2 * w) * mk * 4 if routed else 0
    return {
        "state": state_b,
        "work": work_b,
        "route": route_b,
        "total": state_b + work_b + route_b,
    }


class Trainer:
    def __init__(self, cfg: Config, state: Optional[ModelState] = None):
        enable_compilation_cache()
        # eval-/predict-only Trainers (no train_data) sniff format and nnz
        # from eval_data instead of silently building zero-width batches
        sniff_src = cfg.train_data or cfg.eval_data
        if not cfg.file_type and sniff_src:
            cfg.file_type = detect_file_type(sniff_src)
        if cfg.cmd and not cfg.file_type:
            raise ValueError(
                "--cmd (stdin) streaming cannot auto-detect the format; "
                "pass --file_type libsvm|libffm"
            )
        if cfg.cmd and cfg.max_nnz <= 0:
            raise ValueError(
                "--cmd (stdin) streaming cannot sniff nnz; pass --max_nnz"
            )
        cfg.validate_file_type()
        if cfg.max_nnz <= 0 and sniff_src:
            cfg.max_nnz = sniff_max_nnz(sniff_src, cfg.file_type)
        if cfg.max_nnz <= 0 and not cfg.cmd:
            raise ValueError(
                "max_nnz unknown: pass --max_nnz or provide train/eval data "
                "to sniff it from"
            )
        self.cfg = cfg
        self.model = make_model(cfg)
        self._warn_if_oversized()
        if state is not None:
            _validate_state_shapes(cfg, state)
        self.state = state if state is not None else self.model.init()

        self._steps_done = 0
        self._sharded = None
        # ---- multi-host: one process per host, SPMD over the global mesh
        # (the reference is strictly single-process — SURVEY §2c).  Each
        # process streams its own byte-range of the input and feeds its
        # local slice of every global batch.
        self._proc_id = jax.process_index()
        self._proc_n = jax.process_count()
        if self._proc_n > 1:
            if cfg.cmd:
                raise ValueError("--cmd stdin streaming is single-process only")
            if cfg.batch_size % self._proc_n:
                raise ValueError(
                    f"batch_size {cfg.batch_size} not divisible by "
                    f"{self._proc_n} processes"
                )
            if cfg.mesh_data == 1 and cfg.mesh_model == 1:
                cfg.mesh_data = 0  # default: data-parallel over all devices
        self._local_bs = cfg.batch_size // self._proc_n
        use_mesh = (
            cfg.mesh_model > 1 or cfg.mesh_data > 1 or cfg.mesh_data == 0
            or self._proc_n > 1
        )
        if use_mesh:
            from ftrl_ffm_tpu.parallel import ShardedStep, make_mesh, shard_state

            mesh = make_mesh(cfg.mesh_data, cfg.mesh_model)
            if cfg.batch_size % mesh.shape["data"]:
                raise ValueError(
                    f"batch_size {cfg.batch_size} not divisible by "
                    f"mesh_data {mesh.shape['data']}"
                )
            self.state = shard_state(self.state, mesh)
            self._sharded = ShardedStep(cfg, mesh, self.state)
            self._train_step = self._sharded.train_step
            self._eval_step = jax.jit(self._eval_with_auc_sharded)
            self._train_multi = self._sharded.train_multi
            self._eval_multi = self._sharded.eval_multi
        else:
            # Pin row-major table layouts at the jit boundary (see
            # models/base.py::state_formats — avoids six table-sized
            # transpose copies per step)
            from ftrl_ffm_tpu.models.base import TrainOut, state_formats

            fmt = state_formats(self.state)
            jit_kw = {}
            auto = None
            if fmt is not None:
                # donate: at 1M-row scale a non-donating relayout put briefly
                # holds TWO full table copies (15.4 GB)
                self.state = jax.device_put(self.state, fmt, donate=True)
                auto = fmt.bias_n  # layout-free Format on the same device
                jit_kw = dict(
                    in_shardings=(fmt, auto),
                    out_shardings=TrainOut(
                        state=fmt, logits=auto, loss_sum=auto, count=auto
                    ),
                )
            self._train_step = jax.jit(
                self.model.train_step, donate_argnums=0, **jit_kw
            )
            self._eval_step = jax.jit(
                self._eval_with_auc,
                **({"in_shardings": (fmt, auto)} if fmt is not None else {}),
            )
            self._train_multi = jax.jit(
                self._multi_train_impl,
                donate_argnums=0,
                **(
                    {
                        "in_shardings": (fmt, auto),
                        "out_shardings": (fmt, auto, auto, None),
                    }
                    if fmt is not None
                    else {}
                ),
            )
            self._eval_multi = jax.jit(
                self._multi_eval_impl,
                **({"in_shardings": (fmt, auto)} if fmt is not None else {}),
            )
            self._gather_train_multi = jax.jit(
                self._gather_train_impl,
                donate_argnums=0,
                **(
                    {
                        "in_shardings": (fmt, auto, auto, auto),
                        "out_shardings": (fmt, auto, auto, None),
                    }
                    if fmt is not None
                    else {}
                ),
            )
            self._gather_eval_multi = jax.jit(
                self._gather_eval_impl,
                **(
                    {"in_shardings": (fmt, auto, auto, auto)}
                    if fmt is not None
                    else {}
                ),
            )
            self._gather_train_one = jax.jit(
                self._gather_train_one_impl,
                donate_argnums=0,
                **(
                    {
                        "in_shardings": (fmt, auto, auto, auto),
                        "out_shardings": (fmt, auto, auto),
                    }
                    if fmt is not None
                    else {}
                ),
            )
            self._gather_train_one_iota = jax.jit(
                self._gather_train_one_iota_impl,
                donate_argnums=0,
                **(
                    {
                        "in_shardings": (fmt, auto, auto, auto),
                        "out_shardings": (fmt, auto, auto),
                    }
                    if fmt is not None
                    else {}
                ),
            )
            self._gather_train_unroll = jax.jit(
                self._gather_train_unroll_impl,
                donate_argnums=0,
                **(
                    {
                        "in_shardings": (fmt, auto, auto, auto),
                        "out_shardings": (fmt, auto, auto),
                    }
                    if fmt is not None
                    else {}
                ),
            )
            self._gather_eval_one = jax.jit(
                self._gather_eval_one_impl,
                **(
                    {"in_shardings": (fmt, auto, auto, auto)}
                    if fmt is not None
                    else {}
                ),
            )
            self._gather_eval_one_iota = jax.jit(
                self._gather_eval_one_iota_impl,
                **(
                    {"in_shardings": (fmt, auto, auto, auto)}
                    if fmt is not None
                    else {}
                ),
            )
            self._fmt, self._fmt_auto = fmt, auto
        self._spc = max(1, cfg.steps_per_call)
        # delta-encoding hysteresis: one batch that can't delta-encode
        # disables it for the rest of the run, so the jitted step sees at
        # most one feats-dtype flip (recompiles of the step are expensive)
        self._delta_ok = True
        # DEC6 vals-tier hysteresis (same one-flip contract)
        self._dec6_ok = True
        # Multi-host dynamic-narrowing agreement (see _compact): per-stream
        # observations from the first full pass and the agreed contract
        self._dyn_obs: dict = {}
        self._dyn_agreed: dict = {}
        # device-resident offline datasets (Config.device_cache), per role
        self._dev_cache: dict = {}
        # auc_mode=exact conflicts that are knowable NOW fail NOW — not
        # after a full training epoch at the first evaluate() (the
        # auto-resolved shard cache layout stays a runtime backstop there)
        if cfg.eval_auc and cfg.auc_mode == "exact":
            if self._proc_n > 1:
                raise ValueError(
                    "auc_mode=exact collects all scores on one host — use "
                    "auc_mode=binned on multi-process runs"
                )
            if cfg.device_cache_layout == "shard":
                raise ValueError(
                    "auc_mode=exact needs per-example scores; the shard-"
                    "layout device cache reduces to histograms inside "
                    "shard_map — use --device_cache_layout replicate or "
                    "--auc_mode binned"
                )
        # file-order replay unroll factor: read ONCE — the value is baked
        # into _gather_train_unroll's trace, so honoring a mid-process env
        # change would silently desync the host loop's step accounting
        # from the compiled dispatch
        self._iota_unroll = max(
            1, int(os.environ.get("FTRL_IOTA_UNROLL", "1"))
        )

    def _warn_if_oversized(self) -> None:
        """Preflight HBM estimate: a raw XLA RESOURCE_EXHAUSTED from deep in
        the first train step is a bad way to learn the table doesn't fit.
        Estimates state + update working set per device and warns with
        guidance (shard rows / smaller batch) when it approaches the
        device's memory.  Warning only — the estimate is approximate."""
        limit = device_memory_bytes()
        if limit is None:
            return
        est = estimate_hbm_bytes(self.cfg)
        if est["total"] > 0.9 * limit:
            import warnings

            route_note = (
                f" + route buckets {est['route'] / 1e9:.1f}"
                if est["route"]
                else ""
            )
            warnings.warn(
                f"estimated per-device HBM need ~{est['total'] / 1e9:.1f} GB "
                f"(state {est['state'] / 1e9:.1f} + update working set "
                f"{est['work'] / 1e9:.1f}{route_note}) vs "
                f"~{limit / 1e9:.0f} GB available — RESOURCE_EXHAUSTED "
                f"likely (the estimate ignores XLA temp reuse).  Shard "
                f"rows over --mesh_model, reduce --batch_size, or set "
                f"--table_dtype bfloat16."
            )

    # ---- multi-step (one dispatch per S batches, lax.scan) ----
    def _multi_train_impl(self, state: ModelState, batches: Batch):
        def body(st, b):
            out = self.model.train_step(st, b)
            return out.state, (out.loss_sum, out.count)

        state, (ls, ct) = jax.lax.scan(body, state, batches)
        return state, jnp.sum(ls), jnp.sum(ct), None

    # ---- device-resident offline epochs (Config.device_cache) ----
    # The dataset lives in device memory; each dispatch receives only
    # [S, B] int32 permutation indices and gathers its batches on device —
    # the device form of the reference's in-memory offline mode
    # (src/task/ftrl_offline.cpp:21-42, 63-103: load everything, shuffle
    # indices, train from memory).  Padded index rows point at the one
    # appended inert row (feat id = n_feats, value 0) and get sample_w 0,
    # so gathered batches equal the streamed batch_iterator's exactly
    # (remaining diff: ulp-level jit-boundary fusion, like steps_per_call).
    def _gather_train_impl(self, state: ModelState, ds, idx, n_real):
        def body(st, ix):
            out = self.model.train_step(st, self._take_cached(ds, ix, n_real))
            return out.state, (out.loss_sum, out.count)

        state, (ls, ct) = jax.lax.scan(body, state, idx)
        # per-step sums stay un-reduced: the host accumulates them in f64
        # exactly like the streamed path (train_epoch's pass accounting)
        return state, ls, ct, None

    def _gather_train_one_impl(self, state: ModelState, ds, ix, n_real):
        """Single cached train step ([B] permutation indices, no scan).

        The default dispatch shape:
        * NOT a lax.scan over steps — carrying the state through a scan
          breaks XLA's in-place aliasing of the scatter/closed-form buffers
          (loop-carried tables ping-pong, as in the streamed multi-step
          dispatch).
        * NOT a device-resident [S, B] permutation table with a scalar
          step index — the dynamic row slice serializes INTO the step's
          critical path, while the [B] row upload overlaps the previous
          step's compute (async dispatch).
        One donated dispatch per step keeps the streamed path's update
        aliasing; the host-side cost is a [B] int32 upload that hides
        behind the device step."""
        out = self.model.train_step(state, self._take_cached(ds, ix, n_real))
        return out.state, out.loss_sum, out.count

    def _iota_rows(self, step_ix, n_real):
        """[B] index row for file-order replay, generated ON DEVICE from a
        scalar step index: ix = step*B + iota, tail clamped to the inert pad
        row (== _cached_idx's padding).  Replaces the per-step [B] int32
        upload for identity-order cached passes — 4 bytes/step instead of
        4·B through the host→device link.  (Unlike the rejected [S, B]
        device index table, there is nothing to dynamic-slice: the row is
        fused into the gather's index computation.)"""
        ix = step_ix * self._local_bs + jnp.arange(
            self._local_bs, dtype=jnp.int32
        )
        return jnp.where(ix < n_real, ix, n_real)

    def _gather_train_one_iota_impl(self, state: ModelState, ds, step_ix, n_real):
        """File-order replay train step (online cached epochs): the
        identity permutation needs no host-built index row — see
        _iota_rows."""
        ix = self._iota_rows(step_ix, n_real)
        out = self.model.train_step(state, self._take_cached(ds, ix, n_real))
        return out.state, out.loss_sum, out.count

    def _gather_train_unroll_impl(self, state: ModelState, ds, step0, n_real):
        """U file-order replay steps UNROLLED in one dispatch (not a scan:
        loop-carried tables under lax.scan ping-pong instead of updating in
        place).  Amortizes per-dispatch latency over U steps; the epoch
        tail uses single-step dispatches."""
        ls_l, ct_l = [], []
        for k in range(self._iota_unroll):
            ix = self._iota_rows(step0 + k, n_real)
            out = self.model.train_step(state, self._take_cached(ds, ix, n_real))
            state = out.state
            ls_l.append(out.loss_sum)
            ct_l.append(out.count)
        return state, jnp.stack(ls_l), jnp.stack(ct_l)

    def _gather_eval_one_iota_impl(self, state: ModelState, ds, step_ix, n_real):
        ix = self._iota_rows(step_ix, n_real)
        b = self._take_cached(ds, ix, n_real)
        ls, ct, logits = self.model.eval_step(state, b)
        pos, neg = StreamingAUC.bucket_counts(logits, b.y, b.sample_w, AUC_BINS)
        return ls, ct, pos, neg

    def _gather_eval_one_impl(self, state: ModelState, ds, ix, n_real):
        b = self._take_cached(ds, ix, n_real)
        ls, ct, logits = self.model.eval_step(state, b)
        pos, neg = StreamingAUC.bucket_counts(logits, b.y, b.sample_w, AUC_BINS)
        return ls, ct, pos, neg

    def _gather_eval_impl(self, state: ModelState, ds, idx, n_real):
        def body(carry, ix):
            ls0, ct0, pos0, neg0 = carry
            b = self._take_cached(ds, ix, n_real)
            ls, ct, logits = self.model.eval_step(state, b)
            pos, neg = StreamingAUC.bucket_counts(logits, b.y, b.sample_w, AUC_BINS)
            return (ls0 + ls, ct0 + ct, pos0 + pos, neg0 + neg), None

        init = (
            jnp.zeros((), jnp.float32),
            jnp.zeros((), jnp.float32),
            jnp.zeros((AUC_BINS,), jnp.float32),
            jnp.zeros((AUC_BINS,), jnp.float32),
        )
        (ls, ct, pos, neg), _ = jax.lax.scan(body, init, idx)
        return ls, ct, pos, neg, None

    def _multi_eval_impl(self, state: ModelState, batches: Batch):
        def body(carry, b):
            ls0, ct0, pos0, neg0 = carry
            ls, ct, logits = self.model.eval_step(state, b)
            pos, neg = StreamingAUC.bucket_counts(logits, b.y, b.sample_w, AUC_BINS)
            return (ls0 + ls, ct0 + ct, pos0 + pos, neg0 + neg), None

        init = (
            jnp.zeros((), jnp.float32),
            jnp.zeros((), jnp.float32),
            jnp.zeros((AUC_BINS,), jnp.float32),
            jnp.zeros((AUC_BINS,), jnp.float32),
        )
        (ls, ct, pos, neg), _ = jax.lax.scan(body, init, batches)
        return ls, ct, pos, neg, None

    def _eval_with_auc_sharded(self, state: ModelState, batch: Batch):
        loss_sum, count, logits, overflow = self._sharded.eval_step(state, batch)
        pos, neg = StreamingAUC.bucket_counts(
            logits, batch.y, batch.sample_w, AUC_BINS
        )
        return loss_sum, count, pos, neg, overflow

    def _gather_eval_auc_sharded_impl(self, state: ModelState, ds, ix, n_real):
        """Cached-dataset twin of _eval_with_auc_sharded: the sharded eval
        gathers its batch on device; y/sample_w for the AUC buckets are
        re-derived from the (replicated) dataset outside the shard_map."""
        ls, ct, logits, of = self._sharded.gather_eval_one(state, ds, ix, n_real)
        y = jnp.take(ds[3], ix, axis=0)
        sw = (ix < n_real).astype(jnp.float32)
        pos, neg = StreamingAUC.bucket_counts(logits, y, sw, AUC_BINS)
        return ls, ct, pos, neg, of

    def _eval_with_auc(self, state: ModelState, batch: Batch):
        loss_sum, count, logits = self.model.eval_step(state, batch)
        pos, neg = StreamingAUC.bucket_counts(
            logits, batch.y, batch.sample_w, AUC_BINS
        )
        return loss_sum, count, pos, neg, None

    # ---- exact-AUC eval steps (Config.auc_mode="exact") ----
    def _ensure_exact_eval_steps(self) -> None:
        """Lazily jit the score-returning eval twins: identical loss math,
        but per-example logits/labels/weights come back for the host-side
        exact rank AUC (metrics.exact_auc) instead of device histograms.
        Logits rank identically to sigmoid scores, so no transform needed."""
        if hasattr(self, "_eval_scores_step"):
            return
        if self._sharded is None:

            def _streamed(state, batch):
                ls, ct, logits = self.model.eval_step(state, batch)
                return ls, ct, logits, batch.y, batch.sample_w

            def _cached(state, ds, ix, n_real):
                b = self._take_cached(ds, ix, n_real)
                ls, ct, logits = self.model.eval_step(state, b)
                return ls, ct, logits, b.y, b.sample_w

        else:

            def _streamed(state, batch):
                ls, ct, logits, of = self._sharded.eval_step(state, batch)
                return ls, ct, logits, batch.y, batch.sample_w, of

            def _cached(state, ds, ix, n_real):
                ls, ct, logits, of = self._sharded.gather_eval_one(
                    state, ds, ix, n_real
                )
                y = jnp.take(ds[3], ix, axis=0)
                sw = (ix < n_real).astype(jnp.float32)
                return ls, ct, logits, y, sw, of

        self._eval_scores_step = jax.jit(_streamed)
        self._gather_eval_scores_one = jax.jit(_cached)

    @property
    def logical_state(self) -> ModelState:
        """Host-logical state: id row order, sliced to n_feats.

        Sharded states live in physical (modulo-interleaved, padded) row
        order — every export/checkpoint boundary must go through this."""
        if self._sharded is not None:
            from ftrl_ffm_tpu.parallel import unshard_state

            return unshard_state(
                self.state, self._sharded.n_shards, self.cfg.n_feats
            )
        self._maybe_sync_lin()
        return self.state

    def _lin_rides_stale(self) -> bool:
        """True when train steps skip the separate linear-table update and
        leave the lin arrays stale (huge-table in-place path with the
        dead-lane mirror — see Model._lin_mirror_maintained)."""
        st = self.state
        if self._sharded is not None or st.vec_n is None:
            return False
        from ftrl_ffm_tpu.ftrl import select_update_kind

        nnz = self.cfg.batch_size * max(1, self.cfg.max_nnz)
        kind = select_update_kind(
            st.vec_n.shape[0], st.vec_n.shape[-1], nnz, self.cfg.update_mode
        )
        return kind == "inplace" and self.model._lin_mirror_maintained()

    def _maybe_sync_lin(self) -> None:
        """Reconcile stale linear tables from the factor-table mirror lane
        before any state export (checkpoints, reference blobs,
        logical_state reads).  Idempotent and boundary-only."""
        if self._lin_rides_stale():
            self.state = self.model.sync_lin_from_mirror(self.state)

    # ---- batch plumbing ----
    def _feed_worker_count(self) -> int:
        """Resolved feeder thread count (Config.feed_workers).

        Multi-host pins 1: the dynamic-narrowing observation/agreement
        protocol (_observe_dyn/_agree_dyn) assumes strictly ordered
        per-batch observation on each process.  --cmd stdin pins 1 too:
        an unbounded interactive stream gains nothing from read-ahead and
        a worker blocked in next() would stall process teardown."""
        if self._proc_n > 1 or self.cfg.cmd:
            return 1
        return max(1, self.cfg.feed_workers)

    def _feed(self, items_iter, place):
        """Background-thread device upload: host->HBM transfers overlap the
        previous step's compute (the device-feed analogue of the reference's
        producer thread staying ahead of its consumers,
        src/concurrent/pc_task.cpp:34-55).  `place` maps one host item to
        its device form.  Unwinds the uploader on consumer abandonment or
        error (stop flag + queue drain + join), so no thread / device-batch
        buffers leak in long-lived processes."""
        import queue as _queue
        import sys as _sys
        import threading as _threading

        workers = self._feed_worker_count()
        if workers > 1:
            yield from self._feed_interleaved(items_iter, place, workers)
            return

        q: _queue.Queue = _queue.Queue(maxsize=3)
        err: list[BaseException] = []
        stopped = _threading.Event()
        # locals survive interpreter shutdown (module globals don't); the
        # unwind is skipped there — same guard as stream.py::batches
        empty_exc = _queue.Empty
        finalizing = _sys.is_finalizing

        def upload():
            try:
                for item in items_iter:
                    if stopped.is_set():
                        return
                    q.put(place(item))
            except BaseException as e:
                err.append(e)
            finally:
                q.put(None)

        t = _threading.Thread(target=upload, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    break
                yield b
        finally:
            stopped.set()
            if not finalizing():
                while True:
                    try:
                        q.get_nowait()
                    except empty_exc:
                        break
                t.join(timeout=30)
        if err:
            raise err[0]

    def _feed_interleaved(self, items_iter, place, workers: int):
        """Order-preserving interleaved feeders: `workers` threads each run
        the FULL place() (compact + upload) for alternating batches, with a
        reorder buffer so the consumer still sees stream order (FTRL update
        order is semantics).  Unlike the rejected stage-split design (one
        compact thread piping into one upload thread — LR 527k -> 359k,
        see _device_feed), there is no per-batch handoff between threads:
        each batch crosses threads exactly once, and the GIL-released legs
        (native compact_batch, device transfer) genuinely overlap.

        Shared-state note: place() may flip the _delta_ok hysteresis.  Out
        of order that can interleave delta/non-delta encodings around the
        flip boundary (at most one extra jit aval per leaf) — encodings are
        lossless, so numerics are unchanged."""
        import sys as _sys
        import threading as _threading

        cond = _threading.Condition()
        iter_lock = _threading.Lock()  # serializes (next(), ticket) draws
        buf: dict[int, object] = {}
        seq = [0]            # next ticket to hand out (guarded by iter_lock)
        total = [None]       # item count once items_iter is exhausted
        next_out = [0]       # next index the consumer will yield
        err: list[BaseException] = []
        stopped = _threading.Event()
        finalizing = _sys.is_finalizing
        MAX_AHEAD = 3        # placed batches held beyond the consumer

        # Lock order: iter_lock -> cond, never the reverse.  next() runs
        # under iter_lock ONLY (drawing an item and its order ticket must
        # be atomic), so a producer blocked in next() never wedges the
        # buf/backpressure traffic on cond — and never deadlocks the
        # consumer's teardown, which touches only cond.
        def worker():
            while not stopped.is_set():
                with iter_lock:
                    if total[0] is not None or err:
                        return
                    try:
                        item = next(items_iter)
                    except StopIteration:
                        total[0] = seq[0]
                        with cond:
                            cond.notify_all()
                        return
                    except BaseException as e:
                        with cond:
                            err.append(e)
                            cond.notify_all()
                        return
                    i = seq[0]
                    seq[0] += 1
                with cond:
                    # bound host+device memory: don't run ahead of the
                    # consumer (i == next_out is always allowed, so the
                    # batch the consumer waits for can't deadlock)
                    while (
                        i - next_out[0] > MAX_AHEAD
                        and not stopped.is_set()
                        and not err
                    ):
                        cond.wait(0.2)
                    if stopped.is_set() or err:
                        return
                try:
                    placed = place(item)
                except BaseException as e:
                    with cond:
                        err.append(e)
                        cond.notify_all()
                    return
                with cond:
                    buf[i] = placed
                    cond.notify_all()

        threads = [
            _threading.Thread(target=worker, daemon=True)
            for _ in range(workers)
        ]
        for t in threads:
            t.start()
        try:
            while True:
                with cond:
                    while (
                        next_out[0] not in buf
                        and not err
                        and (total[0] is None or next_out[0] < total[0])
                    ):
                        cond.wait(0.2)
                    if err or next_out[0] not in buf:
                        break
                    b = buf.pop(next_out[0])
                    next_out[0] += 1
                    cond.notify_all()
                yield b
        finally:
            stopped.set()
            with cond:
                cond.notify_all()
            if not finalizing():
                for t in threads:
                    t.join(timeout=30)
            buf.clear()
        if err:
            raise err[0]

    def _device_feed(self, arrays_iter, role: str = "train"):
        # single upload stage by default: splitting compact and device_put
        # into two pipelined threads was slower on a 4-core host (GIL and
        # context-switch overhead beat the overlap win).  feed_workers > 1
        # takes the interleaved form
        # (_feed_interleaved) instead: whole-batch alternation, no handoff.
        return self._feed(arrays_iter, lambda a: self._device_batch(a, role))

    def _device_feed_multi(self, groups_iter, role: str = "train"):
        """Like _device_feed but for [S, ...]-stacked batch groups."""
        return self._feed(
            groups_iter, lambda gr: (self._device_batch(gr[0], role), gr[1])
        )

    # ---- multi-host dynamic-narrowing agreement ----
    # Per-process data-dependent upload dtypes would desync the SPMD avals
    # (divergent compilations / collective mismatch), so multi-host runs
    # OBSERVE each stream's data during its first full pass (epochs re-read
    # the same file / in-memory dataset, so one pass is exact knowledge),
    # AGREE the narrowings across processes with one small allgather at the
    # epoch boundary (main thread, lockstep), and APPLY the agreed contract
    # from the second pass on — verified per batch, raising loudly on any
    # violation rather than desyncing.

    @staticmethod
    def _neutral_obs(f: int) -> dict:
        return {
            "lo": np.full(f, np.iinfo(np.int64).max, np.int64),
            "hi": np.full(f, -1, np.int64),
            "int8": True,
            "bf16": True,
            "sw": True,
        }

    def _observe_dyn(self, role, feats, vals, sample_w) -> None:
        f = feats.shape[-1]
        obs = self._dyn_obs.get(role)
        if obs is None:
            obs = self._dyn_obs[role] = self._neutral_obs(f)
        flat = feats.reshape(-1, f).astype(np.int64)
        valid = flat != self.cfg.n_feats
        any_valid = valid.any(axis=0)
        lo = np.where(
            any_valid,
            np.where(valid, flat, np.iinfo(np.int64).max).min(axis=0),
            obs["lo"],
        )
        hi = np.where(any_valid, np.where(valid, flat, -1).max(axis=0), obs["hi"])
        obs["lo"] = np.minimum(obs["lo"], lo)
        obs["hi"] = np.maximum(obs["hi"], hi)
        if obs["int8"]:
            obs["int8"] = bool(
                np.array_equal(vals.astype(np.int8).astype(np.float32), vals)
            )
        if not obs["int8"] and obs["bf16"]:
            import ml_dtypes

            obs["bf16"] = bool(
                np.array_equal(
                    vals.astype(ml_dtypes.bfloat16).astype(np.float32), vals
                )
            )
        if obs["sw"]:
            obs["sw"] = bool(
                np.array_equal(
                    sample_w.astype(np.int8).astype(np.float32), sample_w
                )
            )

    def _agree_dyn(self, role: str) -> None:
        """One allgather fixes `role`'s narrowings for the rest of the run.

        Lockstep: every process calls this at the same epoch boundary
        (train_epoch end / evaluate end), whether or not it observed data
        (empty byte-range shards contribute neutral elements)."""
        if (
            self._proc_n <= 1
            or not self.cfg.compact_transfer
            or role in self._dyn_agreed
        ):
            return
        from jax.experimental import multihost_utils

        f = self.cfg.max_nnz
        obs = self._dyn_obs.get(role) or self._neutral_obs(f)
        msg = np.concatenate(
            [
                np.array(
                    [obs["int8"], obs["bf16"], obs["sw"]], np.int64
                ),
                obs["lo"],
                obs["hi"],
            ]
        )
        all_msgs = np.asarray(multihost_utils.process_allgather(msg))
        flags = all_msgs[:, :3].all(axis=0)
        lo = all_msgs[:, 3 : 3 + f].min(axis=0)
        hi = all_msgs[:, 3 + f :].max(axis=0)
        seen = hi >= 0
        delta_ok = bool(np.all(~seen | (hi - lo <= 65534)))
        base = np.where(seen, lo, 0).astype(np.int32)
        self._dyn_agreed[role] = {
            "int8": bool(flags[0]),
            "bf16": bool(flags[1]),
            "sw": bool(flags[2]),
            "delta": delta_ok,
            "base": base,
        }

    def _apply_agreed(self, arrays, agreed, fields_c, y_c):
        """Apply an agreed multi-host narrowing contract to one batch,
        verifying losslessness (the stream was fully observed, so a
        violation means the data changed between passes — raise, never
        desync)."""
        _, feats, vals, _, sample_w = arrays[:5]
        feats_base = None
        if agreed["delta"]:
            sent = self.cfg.n_feats
            flat = feats.reshape(-1, feats.shape[-1]).astype(np.int64)
            delta = flat - agreed["base"]
            sentinel = flat == sent
            if bool((~sentinel & ((delta < 0) | (delta > 65534))).any()):
                raise RuntimeError(
                    "compact-transfer contract violated: feature ids moved "
                    "outside the observed per-column ranges between epochs "
                    "(is the input file being modified during training?)"
                )
            feats = np.where(sentinel, 65535, delta).astype(np.uint16).reshape(
                feats.shape
            )
            feats_base = np.concatenate(
                [agreed["base"], np.array([sent], np.int32)]
            )
            if feats.ndim == 3:  # [S, B, F] group: scan slices every leaf
                feats_base = np.tile(feats_base, (feats.shape[0], 1))
        vals_c = vals
        if agreed["int8"]:
            vals_c = vals.astype(np.int8)
            exact = np.array_equal(vals_c.astype(np.float32), vals)
        elif agreed["bf16"]:
            import ml_dtypes

            vals_c = vals.astype(ml_dtypes.bfloat16)
            exact = np.array_equal(vals_c.astype(np.float32), vals)
        else:
            exact = True
        if not exact:
            raise RuntimeError(
                "compact-transfer contract violated: values no longer "
                "exactly representable in the agreed dtype"
            )
        sw_c = sample_w
        if agreed["sw"]:
            sw_c = sample_w.astype(np.int8)
            if not np.array_equal(sw_c.astype(np.float32), sample_w):
                raise RuntimeError(
                    "compact-transfer contract violated: sample weights no "
                    "longer integral"
                )
        return (fields_c, feats, vals_c, y_c, sw_c, feats_base)

    def _split_feats(self, feats):
        """SPLIT transfer tier for delta-refusing ids (models/base.py::Batch):
        (lo uint16, hi-bitplanes uint8 [..., k, ceil(F/8)]) with
        k = bit_length(n_feats) - 16, or None when out of scope.  Lossless
        for ids <= n_feats < 2^24 (the padding sentinel n_feats included) —
        2.03 B/id at Criteo's 100k ids vs 4 B/id int32.  Static per run
        (depends only on cfg.n_feats): at most one extra jit aval.
        Non-sharded runs only — the sharded batch pspecs pin feats_base
        replicated, and the hi plane is per-sample."""
        if self._sharded is not None or not feats.shape[-1]:
            return None
        if os.environ.get("FTRL_SPLIT_FEATS", "1") == "0":
            return None  # measurement aid: A/B the tier off (ids ride int32)
        w = int(self.cfg.n_feats).bit_length()
        if w > 24:
            return None
        k = max(0, w - 16)
        lo = (feats & 0xFFFF).astype(np.uint16)
        hi_packed = _pack_bitplanes((feats >> 16).astype(np.uint8), k)
        return lo, hi_packed

    def _dec6_vals(self, vals):
        """DEC6 vals transfer tier: real-valued features that are 6-decimal
        fixed-point (v = k·10⁻⁶, k < 2²⁴ — exactly what the reference's own
        data prep emits, python/generate_data.py's %.6f MinMax floats) ship
        as 3 little-endian bytes per value instead of f32 (117 vs 156
        B/sample at C=39).  LOSSLESS by construction: the batch is used
        only if every value reconstructs bit-exactly as f32(k)/f32(1e6)
        (division by the EXACT constant reproduces strtof; multiplying by
        the inexact f32 1e-6 is 1 ulp off for ~3% of values) — which is
        precisely what widen_batch computes on device, whose division is
        itself verified bit-identical to the host's once per process
        (_dec6_device_ok).  One-flip hysteresis like _delta_ok keeps jit
        avals bounded.  Returns the [..., 3F] uint8 array or None."""
        if not self._dec6_ok or not vals.shape[-1]:
            return None
        k = np.rint(vals.astype(np.float64) * 1e6)
        if not ((k >= 0).all() and (k < (1 << 24)).all()):
            self._dec6_ok = False
            return None
        recon = k.astype(np.float32) / np.float32(1e6)
        if not np.array_equal(recon, vals):
            self._dec6_ok = False
            return None
        if not self._dec6_device_ok():
            self._dec6_ok = False
            return None
        k = k.astype(np.uint32)
        out = np.empty((*vals.shape[:-1], vals.shape[-1] * 3), np.uint8)
        out[..., 0::3] = k & 0xFF
        out[..., 1::3] = (k >> 8) & 0xFF
        out[..., 2::3] = k >> 16
        return out

    def _pack_fields(self, fields):
        """Bit-packed fields transfer tier: [..., F] field ids ->
        [..., w, ceil(F/8)] uint8 bitplanes with w = bit_length(n_fields-1)
        (6 bits for Criteo's 39 fields vs 8 as int8 — 30 vs 39 B/sample).
        Engaged only when it actually shrinks the upload; static per run
        (depends only on cfg.n_fields).  Non-sharded only — the sharded
        fields pspec is rank-2.  Returns the packed array or None."""
        if self._sharded is not None:
            return None
        f = fields.shape[-1]
        if not f or self.cfg.n_fields < 2:
            return None
        w = int(self.cfg.n_fields - 1).bit_length()
        if w > 8 or w * ((f + 7) // 8) >= f:
            return None
        return _pack_bitplanes(fields.astype(np.uint8), w)

    def _dec6_device_ok(self) -> bool:
        """One-time per-process probe: does dec6_decode's corrected
        mul/add sequence on THIS device reproduce the host's correctly-
        rounded division bit-for-bit?  (It does on XLA CPU over all 2^24
        ks, and chip_smoke.py checks all of them on the GPU; a device's
        plain divide may be reciprocal-based and 1 ulp off for some.)
        Any device where it would not must not take the tier — fail-safe
        to f32 uploads.  Probes 64k random + boundary ks; ~one dispatch +
        readback, amortized over the run."""
        ok = getattr(self, "_dec6_dev_checked", None)
        if ok is None:
            try:
                rng = np.random.default_rng(0)
                k = np.concatenate(
                    [
                        rng.integers(0, 1 << 24, 65536),
                        [0, 1, 999_999, 10**6, (1 << 24) - 1],
                    ]
                ).astype(np.int32)
                from ftrl_ffm_tpu.models.base import dec6_decode

                host = k.astype(np.float32) / np.float32(1e6)
                dev = np.asarray(jax.jit(dec6_decode)(jnp.asarray(k)))
                ok = bool(np.array_equal(host, dev))
            except Exception:
                ok = False
            if not ok:
                print(
                    "note: device f32 division is not bit-identical to the "
                    "host's — DEC6 vals compaction disabled (f32 uploads)"
                )
            self._dec6_dev_checked = ok
        return ok

    def _compact(self, arrays, role: str = "train"):
        """Narrow upload dtypes (see Config.compact_transfer); the jitted
        steps widen on device (models/base.py::widen_batch).

        Lossless only: each narrowing is applied per batch only when the
        round-trip is exact (checked on host — cheap next to the upload it
        saves), so compacting never changes training numerics.  CTR data
        (1.0-valued categoricals, {0,1} labels/weights) always compacts;
        real-valued features ride as f32."""
        if not self.cfg.compact_transfer:
            return arrays
        import ml_dtypes

        # Multi-host: narrowing decisions must be IDENTICAL on every process
        # (each feeds its own byte-range of the global batch; a per-process
        # data-dependent dtype would desync the SPMD avals -> divergent
        # compilations / collective mismatch).  First pass: static
        # narrowings only (fields width from cfg, y int8 — labels are
        # binarized {0,1} by the parse contract) while observing; later
        # passes apply the allgather-agreed contract (_agree_dyn).
        dynamic_ok = self._proc_n == 1
        fields, feats, vals, y, sample_w = arrays[:5]
        fdt = (
            np.int8
            if self.cfg.n_fields <= 127
            else np.int16 if self.cfg.n_fields <= 32767 else np.int32
        )
        # LR and FM never read field ids (their math has no field dimension,
        # reference: src/model/lr.cpp:9-24, src/model/fm.cpp:40-67) — upload
        # a zero-width fields array.  Static per run: no aval flips.
        if self.cfg.model_type != "FFM":
            fields_c = fields[..., :0].astype(np.int8)
        else:
            # FFM: deferred — the native fused pass writes int8 fields
            # alongside the other encodings; numpy fallback casts below
            fields_c = None
        if not dynamic_ok:
            if fields_c is None:
                fields_c = fields.astype(fdt)
            agreed = self._dyn_agreed.get(role)
            if agreed is not None:
                return self._apply_agreed(
                    arrays, agreed, fields_c, y.astype(np.int8)
                )
            if role != "predict":  # predict streams are single-pass
                self._observe_dyn(role, feats, vals, sample_w)
            return (
                fields_c,
                feats,
                vals,
                y.astype(np.int8),
                sample_w,
                None,
            )
        # Native fused compaction: two GIL-released multi-threaded C++
        # passes produce ALL the encodings below byte-identically
        # (native/parser.cpp::ftrl_compact_batch), replacing several
        # single-threaded numpy passes on this (feeder) thread — which sat
        # exactly at the device-step budget at B=16384.  Falls through to
        # the numpy path when no toolchain / non-canonical inputs.
        sent = self.cfg.n_feats
        f_dim = feats.shape[-1]
        res = None
        if f_dim and vals.dtype == np.float32:
            from ftrl_ffm_tpu import native as _native

            nat_fields = (
                fields.reshape(-1, f_dim)
                if self.cfg.model_type == "FFM"
                else None
            )
            # n_threads=1: the two passes are vectorized and memory-bound;
            # std::thread spawn + first-touch page faults made every
            # thread count above 1 slower
            res = _native.compact_batch(
                feats.reshape(-1, f_dim),
                vals.reshape(-1, f_dim),
                nat_fields,
                sent,
                self._delta_ok,
                1,
                fields_i8_ok=self.cfg.n_fields <= 127,
            )
        if res is not None:
            flags, f_u16, base, v_i8, v_bf16, fld_i8 = res
            feats_base = None
            if self._delta_ok:
                if flags & _native.DELTA:
                    feats = f_u16.reshape(feats.shape)
                    feats_base = np.concatenate(
                        [base, np.array([sent], np.int32)]
                    )
                    if feats.ndim == 3:  # [S, B, F] scan group
                        feats_base = np.tile(feats_base, (feats.shape[0], 1))
                else:
                    self._delta_ok = False
            if flags & _native.ALL_ONES:
                vals_c = vals[..., :0]
            elif flags & _native.VALS_I8:
                vals_c = v_i8.reshape(vals.shape)
            elif flags & _native.VALS_BF16:
                vals_c = v_bf16.view(ml_dtypes.bfloat16).reshape(vals.shape)
            else:
                dec = self._dec6_vals(vals)
                vals_c = dec if dec is not None else vals
            if fields_c is None:
                if flags & _native.FIELDS_IOTA:
                    # zero-ROW iota marker: every row's fields are exactly
                    # 0..F-1 (canonical one-feature-per-field data) and the
                    # batch is pad-free — reconstructed on device
                    # (models/base.py::widen_batch)
                    fields_c = fields[..., :0, :].astype(np.int8)
                else:
                    packed = self._pack_fields(fields)
                    if packed is not None:
                        fields_c = packed
                    elif fld_i8 is not None:
                        fields_c = fld_i8.reshape(fields.shape)
                    else:
                        fields_c = fields.astype(fdt)
            sw_i8 = sample_w.astype(np.int8)
            if not np.array_equal(sw_i8.astype(np.float32), sample_w):
                sw_i8 = sample_w  # fractional sample weights: keep f32
            if feats_base is None and feats.dtype == np.int32:
                split = self._split_feats(feats)
                if split is not None:
                    feats, feats_base = split
            return (
                fields_c,
                feats,
                vals_c,
                y.astype(np.int8),
                sw_i8,
                feats_base,
            )
        # padding presence (any sentinel id): decides the delta fast path,
        # the all-ones vals marker and the fields-iota marker below
        flat0 = feats.reshape(-1, feats.shape[-1])
        has_pad = int(flat0.max(initial=0)) == sent if flat0.size else False
        if fields_c is None:
            if not has_pad and np.array_equal(
                fields.reshape(-1, fields.shape[-1]),
                np.broadcast_to(
                    np.arange(fields.shape[-1], dtype=fields.dtype),
                    (fields.size // max(1, fields.shape[-1]),
                     fields.shape[-1]),
                ),
            ):
                fields_c = fields[..., :0, :].astype(np.int8)
            else:
                packed = self._pack_fields(fields)
                fields_c = (
                    packed if packed is not None else fields.astype(fdt)
                )
        # feats: per-column uint16 delta encoding.  CTR ids cluster in
        # per-field vocab ranges, so (max - min) per column is tiny even when
        # n_feats is huge; delta 65535 is reserved for the padding sentinel.
        feats_base = None
        if self._delta_ok and dynamic_ok:
            flat = flat0
            if not has_pad:
                # fast path — no padding rows (every batch but the last):
                # plain per-column min/max, no boolean-mask temps (several
                # times cheaper than the masked form below)
                lo = flat.min(axis=0)
                hi = flat.max(axis=0)
                valid = None
            else:
                valid = flat != sent
                any_valid = valid.any(axis=0)
                lo = np.where(
                    any_valid,
                    np.where(valid, flat, np.iinfo(np.int32).max).min(axis=0),
                    0,
                )
                hi = np.where(any_valid, np.where(valid, flat, -1).max(axis=0), 0)
            # ids are non-negative int32, so hi - lo cannot overflow
            if bool(((hi - lo) <= 65534).all()):
                if valid is None:
                    delta = (flat - lo).astype(np.uint16)
                else:
                    delta = np.where(valid, flat - lo, 65535).astype(np.uint16)
                feats = delta.reshape(feats.shape)
                feats_base = np.concatenate(
                    [lo.astype(np.int32), np.array([sent], np.int32)]
                )
                if feats.ndim == 3:  # [S, B, F] group: scan slices every leaf
                    feats_base = np.tile(feats_base, (feats.shape[0], 1))
            else:
                self._delta_ok = False
        # vals: zero-width all-ones marker when the batch is exactly all-1.0
        # with no padding (the canonical CTR case — widen_batch reconstructs
        # ones on device), else int8 when integral, bfloat16 when exact,
        # else f32 — never lossy.  At most two vals avals per run (full
        # batches take the marker, the padded epoch tail takes the dtype
        # path), so the jit cache stays bounded.
        vals_c, sw_i8 = vals, sample_w
        if dynamic_ok:
            if not has_pad and np.all(vals == 1.0):
                vals_c = vals[..., :0]
            else:
                vals_i8 = vals.astype(np.int8)
                if np.array_equal(vals_i8.astype(np.float32), vals):
                    vals_c = vals_i8
                else:
                    vals_bf16 = vals.astype(ml_dtypes.bfloat16)
                    if np.array_equal(vals_bf16.astype(np.float32), vals):
                        vals_c = vals_bf16
                    else:
                        dec = self._dec6_vals(vals)
                        if dec is not None:
                            vals_c = dec
            sw_i8 = sample_w.astype(np.int8)
            if not np.array_equal(sw_i8.astype(np.float32), sample_w):
                sw_i8 = sample_w  # fractional sample weights: keep f32
        if dynamic_ok and feats_base is None and feats.dtype == np.int32:
            split = self._split_feats(feats)
            if split is not None:
                feats, feats_base = split
        return (
            fields_c,
            feats,
            vals_c,
            y.astype(np.int8),  # labels are binarized {0,1} at parse time
            sw_i8,
            feats_base,
        )

    def _place_batch(self, arrays) -> Batch:
        """Upload one already-compacted batch ([B, ...] or [S, B, ...])."""
        if self._sharded is not None:
            if arrays[0].ndim == 3:
                return self._sharded.place_batch_multi(arrays)
            return self._sharded.place_batch(arrays)
        return Batch(*(None if a is None else jnp.asarray(a) for a in arrays))

    def _device_batch(self, arrays, role: str = "train") -> Batch:
        return self._place_batch(self._compact(arrays, role))

    def _grouped(self, arrays_iter, s: int):
        """Stack batches into [S, ...] groups; the remainder group is padded
        with inert batches (sample_w 0, sentinel feature ids) so every
        dispatch compiles to the same shape."""
        cfg = self.cfg
        group: list[tuple] = []

        def stack(g):
            if len(g) < s:
                b, f = g[0][0].shape
                inert = (
                    np.zeros((b, f), np.int32),
                    np.full((b, f), cfg.n_feats, np.int32),
                    np.zeros((b, f), np.float32),
                    np.zeros(b, np.float32),
                    np.zeros(b, np.float32),
                )
                g = g + [inert] * (s - len(g))
            return tuple(np.stack([t[i] for t in g]) for i in range(5))

        for arrays in arrays_iter:
            group.append(arrays)
            if len(group) == s:
                yield stack(group), s
                group = []
        if group:
            yield stack(group), len(group)

    def _byte_range(self, path: str):
        """This process's line-aligned slice of `path` (None = whole file)."""
        if self._proc_n <= 1:
            return None
        from ftrl_ffm_tpu.data.loader import process_byte_range

        return process_byte_range(path, self._proc_id, self._proc_n)

    def _global_steps(self, local_n: int) -> int:
        """Per-epoch step count every process agrees on.  Collectives are
        lockstep: processes with fewer local samples pad with inert batches
        so every process dispatches the same number of steps."""
        steps = -(-local_n // self._local_bs) if local_n else 0
        if self._proc_n == 1:
            return steps
        from jax.experimental import multihost_utils

        counts = multihost_utils.process_allgather(
            jnp.asarray([steps], jnp.int32)
        )
        return int(np.max(counts))

    def _inert_batch(self):
        b, f = self._local_bs, self.cfg.max_nnz
        return (
            np.zeros((b, f), np.int32),
            np.full((b, f), self.cfg.n_feats, np.int32),
            np.zeros((b, f), np.float32),
            np.zeros(b, np.float32),
            np.zeros(b, np.float32),
        )

    def _pad_to_steps(self, it, n_steps: int):
        k = 0
        for b in it:
            yield b
            k += 1
        while k < n_steps:
            yield self._inert_batch()
            k += 1

    def _ensure_ds(self, role: str):
        """Load (once) the offline in-memory dataset for `role`
        (reference: src/task/ftrl_offline.cpp:21-42 loads full datasets in
        the ctor; here lazily on first use)."""
        cfg = self.cfg
        attr = "_train_ds" if role == "train" else "_eval_ds"
        if not hasattr(self, attr):
            path = cfg.train_data if role == "train" else cfg.eval_data
            setattr(
                self,
                attr,
                load_file(
                    path,
                    cfg.file_type,
                    cfg.max_nnz,
                    cfg.n_feats,
                    cfg.n_fields,
                    n_workers=cfg.n_threads,
                    byte_range=self._byte_range(path),
                ),
            )
        return getattr(self, attr)

    def _cache_batch_devs(self) -> int:
        """Device count along the batch axes (1 unsharded)."""
        if self._sharded is None:
            return 1
        m = self._sharded.mesh.shape
        out = 1
        for a in self._sharded._batch_axes:
            out *= m[a]
        return out

    def _resolve_cache_layout(self, n: int) -> Optional[str]:
        """Which cached-dataset layout engages for an n-sample dataset
        (n = THIS process's slice), or None to stream (Config.device_cache
        / device_cache_layout).  `_device_cache_fits` is always True under
        device_cache="on"."""
        d = self._cache_batch_devs()
        want = self.cfg.device_cache_layout
        if self._proc_n > 1:
            # each process holds only its byte-range slice, so replicate
            # is impossible without an allgather of the dataset — the
            # multi-process cache is shard-layout only (which is already
            # its semantics: per-slice shuffle, lockstep steps)
            if want == "replicate":
                return None
            per_dev = -(-n // max(1, d // self._proc_n))
            return "shard" if self._device_cache_fits(per_dev) else None
        if self._sharded is None or d == 1:
            # shard layout degenerates to replicate on one batch device
            if self._device_cache_fits(n):
                return "replicate"
            # raw doesn't fit: compact in-HBM storage may still
            # (Config.device_cache_compact; decided again at build)
            if self._sharded is None and self.cfg.device_cache_compact != (
                "off"
            ) and self._device_cache_fits(
                n, self._compact_cache_row_bytes()
            ):
                return "replicate"
            return None
        if want == "replicate":
            return "replicate" if self._device_cache_fits(n) else None
        per_dev = -(-n // d)
        if want == "shard":
            return "shard" if self._device_cache_fits(per_dev) else None
        if self._device_cache_fits(n):
            return "replicate"
        if self._device_cache_fits(per_dev):
            return "shard"
        return None

    def _ensure_device_cache(self, role: str):
        """Device-resident offline dataset for `role`, or None when the mode
        is not engaged (Config.device_cache).

        Engaged: file-backed input (never --cmd stdin for train) and (auto)
        the arrays fit per-device HBM next to the state + update working
        set; for online TRAIN, auto additionally requires n_epochs > 1
        (nothing amortizes the blocking build on a single pass).  Online
        TRAIN epochs replay the cache in file order (stream semantics, no
        shuffle) — under the shard layout the slices are stored stream-
        interleaved so global batch composition matches the streamed
        sharded feed exactly; offline epochs shuffle per Config.  The
        uploaded dataset carries inert pad rows (field 0, feat id =
        n_feats, value 0) that padded permutation indices point at, so a
        gathered batch equals the streamed batch_iterator's padded batches.
        On a sharded mesh the dataset is replicated per device (global
        shuffle, streamed-identical batches) or sharded 1/D per device
        (per-slice shuffle, the multi-host streamed semantics) — see
        Config.device_cache_layout and ShardedStep.build_cached_steps.
        Multi-process runs use the shard layout: each process splits its
        byte-range slice over its local devices and the global arrays are
        assembled with make_array_from_process_local_data — exactly the
        placement the streamed multi-host batches use."""
        cfg = self.cfg
        if cfg.device_cache == "off":
            return None
        if cfg.online and role == "train" and cfg.cmd:
            # stdin cannot be re-read (and each epoch may carry new data) —
            # the --cmd stream always trains streamed
            return None
        if (
            cfg.online
            and role == "train"
            and cfg.device_cache == "auto"
            and cfg.n_epochs <= 1
        ):
            # single-pass online run: the cache build is a BLOCKING full-file
            # parse + upload that no replay epoch ever amortizes, while the
            # streamed feed overlaps parsing with device compute — auto
            # stays streamed; "on" engages unconditionally
            return None
        if self._sharded is not None and self._spc > 1:
            return None  # scan grouping: the streamed sharded multi covers it
        if role == "eval" and not cfg.eval_data:
            return None
        if role not in self._dev_cache:
            if cfg.online:
                # ONLINE streamed passes never load the file into RAM;
                # don't pay a full parse (and a resident parsed copy) just
                # to discover the cache declines — pre-gate on a parse-free
                # line count (blank lines overcount: conservative).  When
                # the cache engages for online TRAIN, epochs replay the
                # HBM-resident dataset in file order — identical batches to
                # the streamed single-pass-per-epoch semantics (reference
                # ftrl_online.cpp:42-58 rewinds and re-reads the same file
                # each epoch), with zero host parse work after the build.
                from ftrl_ffm_tpu.data.loader import count_lines

                path = cfg.train_data if role == "train" else cfg.eval_data
                n_est = count_lines(path, self._byte_range(path))
                if self._resolve_cache_layout(max(n_est, 1)) is None:
                    self._dev_cache[role] = None
                    return None
            pre_stat = None
            if cfg.online:
                # source identity BEFORE the parse starts: a write landing
                # while we parse/upload must be seen as staleness on the
                # next pass, so the snapshot is never recorded as fresher
                # than the rows it actually holds (TOCTOU)
                p = cfg.train_data if role == "train" else cfg.eval_data
                st0 = os.stat(p)
                pre_stat = (st0.st_size, st0.st_mtime_ns)
            ds = self._ensure_ds(role)
            self._dev_cache[role] = None
            layout = self._resolve_cache_layout(ds.n) if ds.n > 0 else None
            if layout is not None:
                self._dev_cache[role] = self._build_device_cache(
                    ds, layout, role, pre_stat
                )
                # the parsed host copy is dead once the dataset lives in
                # device memory (the streamed fallback is never used for a
                # cached role) — free it instead of holding both for the
                # run's lifetime
                delattr(self, "_train_ds" if role == "train" else "_eval_ds")
        return self._dev_cache[role]

    def _fresh_cache(self, role: str):
        """The role's device cache, rebuilt first if the source file changed
        since the snapshot was built.  Streamed online re-reads the file
        every pass (the reference's rewind, pc_task.cpp:15-20), so an online
        replay must not serve a stale snapshot; offline caches carry no
        src_stat (the reference loads once at ctor) and pass through."""
        cache = self._ensure_device_cache(role)
        if cache is None or cache.src_stat is None:
            return cache
        path = self.cfg.train_data if role == "train" else self.cfg.eval_data
        st = os.stat(path)
        stale = (st.st_size, st.st_mtime_ns) != cache.src_stat
        if self._proc_n > 1:
            # the rebuild allgathers; every process must take the same
            # branch even if only one host observed the change
            from jax.experimental import multihost_utils

            stale = bool(
                np.max(
                    multihost_utils.process_allgather(
                        np.asarray(stale, np.int32)
                    )
                )
            )
        if stale:
            if self._proc_id == 0:
                print(
                    f"WARNING: {role} file changed since the device cache "
                    "was built — re-reading it (streamed-online rewind "
                    "semantics)"
                )
            # drop every reference to the old device arrays BEFORE the
            # rebuild parses + uploads the replacement: a near-HBM-budget
            # dataset held twice transiently would RESOURCE_EXHAUSTED on
            # exactly the path that is supposed to be transparent
            del self._dev_cache[role]
            cache = None
            cache = self._ensure_device_cache(role)
        return cache

    def _build_device_cache(
        self, ds, layout: str, role: str = "train", pre_stat=None
    ):
        cfg = self.cfg
        f = cfg.max_nnz
        # dataset-level canonical-content markers (the cached twin of
        # _compact's per-batch zero-size markers): store only a zero-size
        # sentinel when fields/vals carry no information.  Multi-process:
        # the marker decision must be GLOBAL (it changes the jitted
        # program's input shapes, which every process must agree on)
        lr_fm = cfg.model_type in ("LR", "FM")
        iota_fields = (
            not lr_fm
            and (ds.fields == np.arange(f, dtype=np.int32)).all()
        )
        ones_vals = (ds.vals == 1.0).all()
        if self._proc_n > 1:
            from jax.experimental import multihost_utils

            flags = np.asarray(
                multihost_utils.process_allgather(
                    np.asarray([iota_fields, ones_vals], np.int32)
                )
            ).reshape(self._proc_n, 2)
            iota_fields = bool(flags[:, 0].all())
            ones_vals = bool(flags[:, 1].all())

        if layout == "shard":
            # split THIS process's slice over its local batch devices;
            # rows_loc (padded rows per device) is agreed globally
            d_global = self._cache_batch_devs()
            d = d_global // self._proc_n
            if d < 1 or d_global % self._proc_n:
                raise ValueError(
                    f"batch-axis devices ({d_global}) must be a multiple "
                    f"of process count ({self._proc_n}) for the shard-"
                    f"layout device cache"
                )
            if cfg.online and role == "train":
                # FILE-ORDER replay: assign each device the exact rows the
                # streamed sharded path would hand it (place_batch gives
                # device j rows [t*B + j*b_dev, t*B + (j+1)*b_dev) of the
                # stream at step t), so the identity per-slice permutation in
                # _cached_idx_shard reproduces the streamed global batch
                # composition EXACTLY — not just the same row set.  Each
                # device's real rows stay contiguous-in-step order (all steps
                # but the last contribute a full b_dev), so pad-at-end keeps
                # alignment
                bs = self._local_bs
                b_dev = bs // d
                if b_dev * d != bs:
                    raise ValueError(
                        f"per-process batch ({bs}) must divide over its "
                        f"batch-axis devices ({d}) for the shard-layout "
                        f"device cache"
                    )
                s_ep = -(-ds.n // bs) if ds.n else 0
                flat = np.arange(s_ep * bs, dtype=np.int64)
                per_dev = (
                    flat.reshape(s_ep, d, b_dev)
                    .transpose(1, 0, 2)
                    .reshape(d, -1)
                )
                dev_idx = [row[row < ds.n] for row in per_dev]
            else:
                # offline: contiguous 1/D slices, shuffled per-slice each
                # epoch (the cached twin of the multi-host streamed
                # semantics; NOT the single-process streamed global shuffle)
                base, rem = divmod(ds.n, d)
                cnt = [base + (1 if i < rem else 0) for i in range(d)]
                offs = np.concatenate([[0], np.cumsum(cnt)])
                dev_idx = [
                    np.arange(offs[i], offs[i + 1]) for i in range(d)
                ]
            n_loc = [len(ix) for ix in dev_idx]
            max_loc = max(n_loc)
            if self._proc_n > 1:
                max_loc = int(
                    np.max(
                        multihost_utils.process_allgather(
                            np.asarray(max_loc, np.int64)
                        )
                    )
                )
            rows_loc = max_loc + 1  # + inert pad row per device

            def blocks(arr, pad_row):
                """local [n, ...] -> [d * rows_loc, ...]: per-device row
                selections (contiguous offline / stream-interleaved online),
                each padded with inert rows."""
                parts = []
                for i in range(d):
                    parts.append(arr[dev_idx[i]])
                    pad = rows_loc - n_loc[i]
                    parts.append(np.repeat(pad_row, pad, axis=0))
                return np.concatenate(parts)
        else:
            n_loc, rows_loc = None, None

            def blocks(arr, pad_row):
                return np.concatenate([arr, pad_row])

        pad_fields = np.zeros((1, f), np.int32)
        pad_feats = np.full((1, f), cfg.n_feats, np.int32)
        if lr_fm:
            fields_h = np.zeros((0, 0), np.int32)  # never read
        elif iota_fields:
            fields_h = np.zeros((0, f), np.int32)  # iota marker
        else:
            fields_h = blocks(ds.fields, pad_fields)
        if ones_vals:
            vals_h = np.zeros((0, f), np.float32)  # all-ones marker
        else:
            vals_h = blocks(ds.vals, np.zeros((1, f), np.float32))
        ds_host = (
            fields_h,
            blocks(ds.feats, pad_feats),
            vals_h,
            blocks(ds.y, np.zeros(1, np.float32)),
        )

        n_real_dev = None
        idx_sharding = None
        compact = False
        if self._sharded is None and self._cache_compact_mode(ds.n):
            ds_host = self._compact_cache_arrays(ds_host)
            compact = True
        if self._sharded is None:
            ds_dev = tuple(jnp.asarray(a) for a in ds_host)
        else:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P

            mesh = self._sharded.mesh
            axes = self._sharded._batch_axes
            spec = P() if layout == "replicate" else P(axes)
            sh = NamedSharding(mesh, spec)
            if self._proc_n > 1:
                # the global array spans processes: each contributes its
                # local devices' blocks (same placement as streamed
                # multi-host batches, sharded.py::place_batch)
                d_global = self._cache_batch_devs()

                def put(a):
                    gshape = (d_global * rows_loc,) + a.shape[1:]
                    if a.shape[0] == 0:  # zero-size marker: global too
                        gshape = (0,) + a.shape[1:]
                    return jax.make_array_from_process_local_data(
                        sh, a, gshape
                    )

                ds_dev = tuple(put(a) for a in ds_host)
                n_real_dev = jax.make_array_from_process_local_data(
                    NamedSharding(mesh, P(axes)),
                    np.asarray(n_loc, np.int32),
                    (d_global,),
                )
                idx_sharding = NamedSharding(mesh, P(axes))
            else:
                ds_dev = jax.device_put(ds_host, sh)
                if layout == "shard":
                    n_real_dev = jax.device_put(
                        np.asarray(n_loc, np.int32),
                        NamedSharding(mesh, P(axes)),
                    )
            self._sharded.build_cached_steps(layout)
            if layout == "replicate":
                self._gather_train_one = self._sharded.gather_train_one
                self._gather_eval_one = jax.jit(
                    self._gather_eval_auc_sharded_impl
                )
        # the cached replay is a SNAPSHOT; streamed online (and the
        # reference's rewind, pc_task.cpp:15-20) re-reads the file each
        # pass — record the source identity so _fresh_cache can detect a
        # changed file and rebuild.  pre_stat was sampled BEFORE the parse
        # (a write landing during parse/upload shows as stale next pass).
        # (train+cmd never reaches here; offline snapshots MATCH the
        # reference, which loads once at ctor, ftrl_offline.cpp:21-42 —
        # no check needed there.)
        src_stat = pre_stat if cfg.online else None
        return _DevCache(
            layout, ds_dev, ds.n, n_loc, rows_loc, n_real_dev, idx_sharding,
            src_stat, compact,
        )

    def _compact_cache_arrays(self, ds_host: tuple) -> tuple:
        """Re-encode the assembled cache arrays (fields, feats, vals, y)
        into their compact in-HBM forms (Config.device_cache_compact).
        Per-leaf, all lossless, all static per run:
          feats  [N, F] i32  -> [N, 2F + k·Pb] u8 (lo bytes ‖ hi bitplanes)
          vals   [N, F] f32  -> [N, 3F] u8 DEC6 when the whole dataset is
                                6-decimal fixed-point (else kept f32)
          fields [N, F] i32  -> [N, w·Pb] u8 bitplanes (w <= 8)
        Zero-size markers and LR/FM fields pass through untouched; y stays
        f32 (4 B/row is noise).  _decode_cached_batch inverts on device."""
        fields_h, feats_h, vals_h, y_h = ds_host
        f = self.cfg.max_nnz
        pb = (f + 7) // 8
        wf = int(self.cfg.n_feats).bit_length()
        if wf <= 24 and feats_h.shape[0]:
            k = max(0, wf - 16)
            lo = (feats_h & 0xFFFF).astype(np.uint16)
            lo8 = np.empty((feats_h.shape[0], 2 * f), np.uint8)
            lo8[:, 0::2] = lo & 0xFF
            lo8[:, 1::2] = lo >> 8
            hi = _pack_bitplanes((feats_h >> 16).astype(np.uint8), k)
            feats_h = np.concatenate(
                [lo8, hi.reshape(feats_h.shape[0], k * pb)], axis=1
            )
        if (
            vals_h.shape[0]
            and vals_h.dtype == np.float32
            and self._dec6_device_ok()
        ):
            kv = np.rint(vals_h.astype(np.float64) * 1e6)
            if (
                (kv >= 0).all()
                and (kv < (1 << 24)).all()
                and np.array_equal(
                    kv.astype(np.float32) / np.float32(1e6), vals_h
                )
            ):
                kv = kv.astype(np.uint32)
                enc = np.empty((vals_h.shape[0], 3 * f), np.uint8)
                enc[:, 0::3] = kv & 0xFF
                enc[:, 1::3] = (kv >> 8) & 0xFF
                enc[:, 2::3] = kv >> 16
                vals_h = enc
        if fields_h.shape[0] and fields_h.shape[-1]:
            w = int(max(self.cfg.n_fields - 1, 1)).bit_length()
            if w <= 8 and w * pb < f:
                fields_h = _pack_bitplanes(
                    fields_h.astype(np.uint8), w
                ).reshape(fields_h.shape[0], w * pb)
        return (fields_h, feats_h, vals_h, y_h)

    def _decode_cached_batch(self, b: Batch) -> Batch:
        """Invert _compact_cache_arrays after the per-step gather (device
        side, inside the jitted gather step — a few elementwise ops on
        [B, F]).  Leaves that kept their wide form pass through; the
        reconstructions are the exact ones the transfer tiers use
        (models/base.py::widen_batch), so batches equal the raw-cache
        path's bit for bit."""
        f = self.cfg.max_nnz
        pb = (f + 7) // 8
        fields, feats, vals = b.fields, b.feats, b.vals
        j = jnp.arange(f)
        if feats.dtype == jnp.uint8:
            u = feats.astype(jnp.int32)
            out = u[..., 0 : 2 * f : 2] | (u[..., 1 : 2 * f : 2] << 8)
            k = max(0, int(self.cfg.n_feats).bit_length() - 16)
            if k:
                planes = u[..., 2 * f :].reshape(*u.shape[:-1], k, pb)
                byte = jnp.take(planes, j // 8, axis=-1)
                bits = (byte >> (7 - (j % 8))) & 1
                out = out + jnp.sum(
                    bits << (16 + jnp.arange(k))[..., None], axis=-2
                )
            feats = out
        if vals.dtype == jnp.uint8:
            from ftrl_ffm_tpu.models.base import dec6_decode

            u = vals.astype(jnp.int32)
            kv = u[..., 0::3] + (u[..., 1::3] << 8) + (u[..., 2::3] << 16)
            vals = dec6_decode(kv)
        if fields.dtype == jnp.uint8 and fields.ndim == feats.ndim:
            w = fields.shape[-1] // pb
            planes = fields.astype(jnp.int32).reshape(
                *fields.shape[:-1], w, pb
            )
            byte = jnp.take(planes, j // 8, axis=-1)
            bits = (byte >> (7 - (j % 8))) & 1
            fields = jnp.sum(bits << jnp.arange(w)[..., None], axis=-2)
        return b._replace(fields=fields, feats=feats, vals=vals)

    def _take_cached(self, ds, ix, n_real) -> Batch:
        """take_cached + the compact-storage decode (trace-static: the
        branch keys off leaf dtypes)."""
        return self._decode_cached_batch(take_cached(ds, ix, n_real))

    def _compact_cache_row_bytes(self) -> int:
        """Conservative per-row bytes of the compact in-HBM dataset form
        (Config.device_cache_compact): split feats + packed fields always
        count; vals count as f32 (the DEC6 eligibility is data-dependent
        and only discovered at build — budgeting the wide form can only
        overestimate)."""
        cfg = self.cfg
        f = cfg.max_nnz
        pb = (f + 7) // 8
        wf = int(cfg.n_feats).bit_length()
        feats_b = (2 * f + max(0, wf - 16) * pb) if wf <= 24 else 4 * f
        if cfg.model_type in ("LR", "FM"):
            fields_b = 0
        else:
            w = int(max(cfg.n_fields - 1, 1)).bit_length()
            fields_b = w * pb if w <= 8 and w * pb < f else f
        return fields_b + feats_b + 4 * f + 4

    def _cache_compact_mode(self, n: int) -> bool:
        """Does compact in-HBM storage engage for an n-row dataset?
        Single-device scope only (the sharded gather steps never decode).
        auto = only when the raw arrays would not fit (default cached
        path stays byte-identical); on = always; off = never."""
        want = self.cfg.device_cache_compact
        if want == "off" or self._sharded is not None:
            return False
        if want == "on":
            return True
        return not self._device_cache_fits(n) and self._device_cache_fits(
            n, self._compact_cache_row_bytes()
        )

    def _device_cache_fits(self, n: int, row_bytes: int = 0) -> bool:
        if self.cfg.device_cache == "on":
            return True
        ds_bytes = (n + 1) * (row_bytes or (12 * self.cfg.max_nnz + 4))
        limit = device_memory_bytes()
        if limit is None:
            return True
        est = estimate_hbm_bytes(self.cfg)
        return est["total"] + ds_bytes <= 0.8 * limit

    def _cached_idx(self, n: int, order: np.ndarray) -> np.ndarray:
        """[n_steps, B] int32 index rows over a permutation, the tail padded
        with pointers at the inert row so every dispatch compiles once."""
        bs = self._local_bs
        n_steps = -(-n // bs)
        pad = n_steps * bs - n
        if pad:
            order = np.concatenate([order, np.full(pad, n, order.dtype)])
        return order.reshape(n_steps, bs).astype(np.int32)

    def _cached_idx_chunks(self, n: int, order: np.ndarray):
        """Yield ([spc, B] int32 index blocks, real-step count) over a
        permutation — the scan-grouped dispatch for steps_per_call > 1."""
        idx = self._cached_idx(n, order)
        n_steps, bs = idx.shape
        chunk = self._spc
        for s0 in range(0, n_steps, chunk):
            part = idx[s0 : s0 + chunk]
            real = part.shape[0]
            if real < chunk:
                part = np.concatenate(
                    [part, np.full((chunk - real, bs), n, np.int32)]
                )
            yield part, real

    def _cached_idx_shard(self, entry: _DevCache, epoch_rng, shuffle: bool):
        """[S, B_local] int32 rows of device-LOCAL indices for the shard
        layout: column block d holds (this process's) device d's slice-
        local permutation, padded at its inert row.  Steps per epoch =
        ceil(global_max_slice / b_device) (from entry.rows_loc, which is
        globally agreed) — the multi-host streamed lockstep count."""
        d = len(entry.n_loc)
        b_dev = self._local_bs // d
        s = -(-(entry.rows_loc - 1) // b_dev)
        cols = []
        for i in range(d):
            perm = np.arange(entry.n_loc[i])
            if shuffle:
                epoch_rng.shuffle(perm)
            pad = s * b_dev - entry.n_loc[i]
            if pad:
                perm = np.concatenate(
                    [perm, np.full(pad, entry.rows_loc - 1, perm.dtype)]
                )
            cols.append(perm.reshape(s, b_dev))
        return np.concatenate(cols, axis=1).astype(np.int32)

    def _cached_row(self, entry: _DevCache, row: np.ndarray):
        """One step's index row, globally placed when the mesh spans
        processes (each process contributes its local devices' slice)."""
        if entry.idx_sharding is None:
            return row
        return jax.make_array_from_process_local_data(
            entry.idx_sharding, row, (self.cfg.batch_size,)
        )

    def _train_epoch_cached(self, cache: _DevCache, epoch_rng, maybe_save) -> float:
        ds_dev, n = cache.ds, cache.n
        # online = stream semantics: every epoch replays the file order
        # (reference ftrl_online.cpp:42-58 rewinds and re-reads; no shuffle)
        shuffle = self.cfg.shuffle and not self.cfg.online
        if cache.layout == "replicate":
            order = np.arange(n)
            if shuffle:
                # same rng call as batch_iterator's host-side shuffle, so the
                # cached and streamed paths see identical permutations
                epoch_rng.shuffle(order)
            n_arr = jnp.asarray(n, jnp.int32)
        sums = []
        overflows = []
        done = 0
        if self._spc > 1:
            for part, real in self._cached_idx_chunks(n, order):
                self.state, ls, ct, _ = self._gather_train_multi(
                    self.state, ds_dev, part, n_arr
                )
                sums.append((ls, ct))  # [spc]-vectors of per-step sums
                prev, done = done, done + real
                maybe_save(self._steps_done + done, self._steps_done + prev)
        elif self._sharded is not None:
            if cache.layout == "shard":
                rows = self._cached_idx_shard(cache, epoch_rng, shuffle)
                n_arr = cache.n_real_dev
                fn = self._sharded.gather_train_one_shard
            else:
                rows = self._cached_idx(n, order)
                fn = self._sharded.gather_train_one
            for row in rows:
                out = fn(self.state, ds_dev, self._cached_row(cache, row), n_arr)
                self.state = out.state
                sums.append((out.loss_sum, out.count))
                if out.route_overflow is not None:
                    overflows.append(out.route_overflow)
                prev, done = done, done + 1
                maybe_save(self._steps_done + done, self._steps_done + prev)
        elif not shuffle and os.environ.get("FTRL_IOTA_REPLAY", "1") != "0":
            # file-order replay (online cached epochs): the identity
            # permutation's rows are generated on device from a scalar step
            # index (_iota_rows) — no [B] upload at all.  Full groups of U
            # steps go out unrolled in one dispatch (FTRL_IOTA_UNROLL,
            # default 1); the tail uses single-step dispatches.
            n_steps = -(-n // self._local_bs)
            u = self._iota_unroll  # read once at Trainer init (trace-baked)
            s_i = 0
            tail = []
            while s_i < n_steps:
                if u > 1 and s_i + u <= n_steps:
                    self.state, ls, ct = self._gather_train_unroll(
                        self.state,
                        ds_dev,
                        np.int32(s_i),
                        n_arr,
                    )
                    sums.append((ls, ct))  # [U] vectors
                    step = u
                else:
                    self.state, ls, ct = self._gather_train_one_iota(
                        self.state,
                        ds_dev,
                        np.int32(s_i),
                        n_arr,
                    )
                    (sums if u == 1 else tail).append((ls, ct))
                    step = 1
                prev, done = done, done + step
                s_i += step
                maybe_save(self._steps_done + done, self._steps_done + prev)
            if tail:  # mixed scalar/vector sums: vectorize the tail once
                sums.append(
                    (
                        jnp.stack([s for s, _ in tail]),
                        jnp.stack([c for _, c in tail]),
                    )
                )
        else:
            # one donated dispatch per step, [B] index row uploaded per
            # dispatch — see _gather_train_one_impl for why neither the
            # scan-grouped form nor a device-resident index table wins
            for row in self._cached_idx(n, order):
                self.state, ls, ct = self._gather_train_one(
                    self.state, ds_dev, row, n_arr
                )
                sums.append((ls, ct))  # scalar per-step sums
                prev, done = done, done + 1
                maybe_save(self._steps_done + done, self._steps_done + prev)
        self._steps_done += done
        of_dev = jnp.sum(jnp.stack(overflows)) if overflows else None
        self._epoch_route_overflow = (
            int(jax.device_get(of_dev)) if of_dev is not None else 0
        )
        if not sums:
            return float("nan")
        # stack scalars / concat vectors ONCE at epoch end (a per-step
        # atleast_1d would be an extra tiny dispatch per step)
        cat = jnp.concatenate if sums[0][0].ndim else jnp.stack
        ls_v, ct_v = jax.device_get(
            (
                cat([s for s, _ in sums]),
                cat([c for _, c in sums]),
            )
        )
        loss_sum = np.sum(np.asarray(ls_v), dtype=np.float64)
        count = np.sum(np.asarray(ct_v), dtype=np.float64)
        acc = LossAccumulator()
        acc.update(loss_sum, count)
        return acc.mean

    def _train_batches(self, epoch_rng: np.random.Generator):
        cfg = self.cfg
        if cfg.online:
            src = sys.stdin if cfg.cmd else cfg.train_data
            reader = StreamReader(
                src,
                cfg.file_type,
                self._local_bs,
                cfg.max_nnz,
                cfg.n_feats,
                cfg.n_fields,
                n_parse_threads=cfg.n_threads,
                byte_range=None if cfg.cmd else self._byte_range(cfg.train_data),
            )
            it = reader.batches()
        else:
            it = batch_iterator(
                self._ensure_ds("train"),
                self._local_bs,
                shuffle=cfg.shuffle,
                rng=epoch_rng,
                sentinel=cfg.n_feats,
            )
        if self._proc_n == 1:
            yield from it
            return
        if not hasattr(self, "_train_steps"):
            from ftrl_ffm_tpu.data.loader import count_lines

            self._train_steps = self._global_steps(
                count_lines(cfg.train_data, self._byte_range(cfg.train_data))
                if cfg.online
                else self._train_ds.n
            )
        yield from self._pad_to_steps(it, self._train_steps)

    def _eval_batches(self):
        cfg = self.cfg
        if cfg.online:
            reader = StreamReader(
                cfg.eval_data,
                cfg.file_type,
                self._local_bs,
                cfg.max_nnz,
                cfg.n_feats,
                cfg.n_fields,
                n_parse_threads=cfg.n_threads,
                byte_range=self._byte_range(cfg.eval_data),
            )
            it = reader.batches()
        else:
            it = batch_iterator(
                self._ensure_ds("eval"),
                self._local_bs,
                shuffle=False,
                sentinel=cfg.n_feats,
            )
        if self._proc_n == 1:
            yield from it
            return
        if not hasattr(self, "_eval_steps"):
            from ftrl_ffm_tpu.data.loader import count_lines

            self._eval_steps = self._global_steps(
                count_lines(cfg.eval_data, self._byte_range(cfg.eval_data))
                if cfg.online
                else self._eval_ds.n
            )
        yield from self._pad_to_steps(it, self._eval_steps)

    # ---- epochs ----
    def train_epoch(self, epoch_rng: Optional[np.random.Generator] = None) -> float:
        if epoch_rng is None:
            # persistent: direct repeated train_epoch() calls must not
            # re-seed per call, or offline shuffles repeat the same
            # permutation every epoch (Trainer.train threads its own rng)
            if not hasattr(self, "_epoch_rng"):
                self._epoch_rng = np.random.default_rng(self.cfg.seed)
            epoch_rng = self._epoch_rng
        sums = []
        save_every = self.cfg.save_every
        s = self._spc
        def maybe_save(step_now: int, step_prev: int):
            # checkpoint whenever a multiple of save_every was crossed
            if save_every and self.cfg.model_path:
                if step_now // save_every > step_prev // save_every:
                    self._save_mid_checkpoint(step_now)

        cache = self._fresh_cache("train")
        if cache is not None:
            loss = self._train_epoch_cached(cache, epoch_rng, maybe_save)
            # a checkpoint due within the epoch is durable once the epoch
            # returns (async writes joined; atomic rename already landed)
            self._join_pending_checkpoint()
            return loss
        overflows = []
        if s > 1:
            n_steps = 0
            groups = self._grouped(self._train_batches(epoch_rng), s)
            for group, real_n in self._device_feed_multi(groups):
                self.state, ls, ct, of = self._train_multi(self.state, group)
                sums.append((ls, ct))
                if of is not None:
                    overflows.append(of)
                prev, n_steps = n_steps, n_steps + real_n
                maybe_save(self._steps_done + n_steps, self._steps_done + prev)
            self._steps_done += n_steps
        else:
            for batch in self._device_feed(self._train_batches(epoch_rng)):
                out = self._train_step(self.state, batch)
                self.state = out.state
                sums.append((out.loss_sum, out.count))
                if out.route_overflow is not None:
                    overflows.append(out.route_overflow)
                maybe_save(self._steps_done + len(sums),
                           self._steps_done + len(sums) - 1)
            self._steps_done += len(sums)
        # first full pass observed the whole train stream: agree the
        # multi-host dynamic narrowings now (lockstep, one allgather, no-op
        # single-process / already-agreed)
        self._agree_dyn("train")
        # a checkpoint due within the epoch is durable once the epoch
        # returns (async writes joined; atomic rename already landed)
        self._join_pending_checkpoint()
        if not sums:
            self._epoch_route_overflow = 0
            return float("nan")
        # One device-side stack + a single host readback (per-batch float()
        # readbacks serialize against the dispatch queue); the cross-step
        # reduction happens on host in f64 — the reference accumulates
        # double over whole passes (src/task/ftrl_online.cpp:82-94), and an
        # f32 chain over 10^4+ step sums loses digits the reference keeps.
        ls_v, ct_v = jax.device_get(
            (
                jnp.stack([s for s, _ in sums]),
                jnp.stack([c for _, c in sums]),
            )
        )
        of_dev = jnp.sum(jnp.stack(overflows)) if overflows else None
        of_sum = jax.device_get(of_dev) if of_dev is not None else None
        loss_sum = np.sum(np.asarray(ls_v), dtype=np.float64)
        count = np.sum(np.asarray(ct_v), dtype=np.float64)
        # route-mode epoch drop counter: exactness observability (the
        # reference updates every occurrence unconditionally,
        # src/model/ftrl_model.cpp:66-77 — any drop must be loud)
        self._epoch_route_overflow = int(of_sum) if of_sum is not None else 0
        acc = LossAccumulator()
        acc.update(loss_sum, count)
        return acc.mean

    def predict_file(self, data_path: str, out_path: str) -> int:
        """Score a libsvm/libffm file: one sigmoid probability per line.

        New capability vs the reference (which can only eval log-loss).
        data_path "-" scores a stdin stream and out_path "-" writes to
        stdout — pipe-based batch serving (`cat f | ... --predict_data -`),
        the scoring twin of --cmd's stdin training
        (reference: src/concurrent/pc_task.cpp:41).
        Returns the number of samples scored."""
        import contextlib
        import sys

        cfg = self.cfg
        if self._proc_n > 1:
            return self._predict_file_multihost(data_path, out_path)
        if data_path == "-" and not cfg.file_type:
            raise ValueError(
                "--predict_data -: stdin cannot be sniffed; set --file_type"
            )
        reader = StreamReader(
            sys.stdin if data_path == "-" else data_path,
            cfg.file_type or detect_file_type(data_path),
            cfg.batch_size,
            cfg.max_nnz,
            cfg.n_feats,
            cfg.n_fields,
            n_parse_threads=cfg.n_threads,
            # no progress prints: they would interleave with the probability
            # stream when out_path is stdout (producer thread, mid-buffer)
            log_every=0,
        )
        total = 0
        out_cm = (
            contextlib.nullcontext(sys.stdout)
            if out_path == "-"
            else open(out_path, "w")
        )
        with out_cm as f:
            for arrays in reader.batches():
                batch = self._device_batch(arrays, role="predict")
                if self._sharded is not None:
                    _, _, logits, of = self._sharded.eval_step(self.state, batch)
                    self._note_eval_overflow(of)
                else:
                    _, _, logits = self._eval_plain(self.state, batch)
                probs = np.asarray(jax.nn.sigmoid(logits), np.float64)
                mask = np.asarray(arrays[4]) > 0  # drop padded tail samples
                for p in probs[mask]:
                    f.write(f"{p:.6f}\n")
                total += int(mask.sum())
        self._flush_eval_overflow("predict")
        return total

    def _local_batch_rows(self, arr) -> np.ndarray:
        """This process's rows of a batch-sharded [B] device array, in
        ascending global-row order.  Every process feeds a contiguous block
        of each global batch (place via make_array_from_process_local_data),
        so its addressable shards hold exactly the rows it fed; shards
        replicated over a non-batch mesh axis are deduplicated by their
        global start index."""
        seen = {}
        for sh in arr.addressable_shards:
            start = sh.index[0].start or 0
            if start not in seen:
                seen[start] = np.asarray(sh.data).reshape(-1)
        rows = np.concatenate([seen[k] for k in sorted(seen)])
        assert rows.shape[0] == self._local_bs, (
            f"addressable rows {rows.shape[0]} != local batch {self._local_bs}"
        )
        return rows

    def _predict_file_multihost(self, data_path: str, out_path: str) -> int:
        """Ordered multi-host scoring (the multi-host form of predict_file).

        Every process streams its byte-range slice of the input in lockstep
        (SPMD eval steps over the global mesh, inert-padded to a common step
        count), per-batch probabilities are allgathered, and the coordinator
        seek-writes each process's fixed-width probability lines at their
        global line offsets — the output is byte-identical to a
        single-process run.  The reference has no multi-process anything
        (SURVEY §2c); this is the scoring twin of multi-host training."""
        from jax.experimental import multihost_utils

        cfg = self.cfg
        if data_path == "-" or out_path == "-":
            raise ValueError(
                "multi-host predict_file needs real file paths (stdin/stdout "
                "streaming is single-process only)"
            )
        from ftrl_ffm_tpu.data.loader import count_lines

        br = self._byte_range(data_path)
        # nonblank: the count maps 1:1 to output rows, and the parsers skip
        # blank lines — a raw newline count would shift every later
        # process's write offsets and emit garbage rows from the padded tail
        lines_local = count_lines(data_path, br, nonblank=True)
        counts = np.asarray(
            multihost_utils.process_allgather(
                jnp.asarray([lines_local], jnp.int32)
            )
        ).reshape(-1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        total = int(counts.sum())
        lb = self._local_bs
        n_steps = int(-(-counts.max() // lb)) if total else 0
        row_bytes = 9  # every line is "0.xxxxxx\n" (prob in [0, 1], %.6f)

        reader = StreamReader(
            data_path,
            cfg.file_type or detect_file_type(data_path),
            lb,
            cfg.max_nnz,
            cfg.n_feats,
            cfg.n_fields,
            n_parse_threads=cfg.n_threads,
            byte_range=br,
            log_every=0,
        )
        out_f = None
        if self._proc_id == 0:
            out_f = open(out_path, "wb")
            out_f.truncate(row_bytes * total)
        try:
            for b_idx, arrays in enumerate(
                self._pad_to_steps(reader.batches(), n_steps)
            ):
                batch = self._device_batch(arrays, role="predict")
                _, _, logits, of = self._sharded.eval_step(self.state, batch)
                self._note_eval_overflow(of)
                local = self._local_batch_rows(jax.nn.sigmoid(logits))
                gathered = np.asarray(multihost_utils.process_allgather(local))
                if out_f is None:
                    continue
                base = b_idx * lb
                for p in range(self._proc_n):
                    valid = min(max(int(counts[p]) - base, 0), lb)
                    if valid <= 0:
                        continue
                    probs = gathered[p, :valid]
                    # the seek-write layout is only sound if every line is
                    # exactly row_bytes — a non-finite probability (NaN
                    # logits from a degenerate state) formats shorter and
                    # would silently misalign every subsequent offset
                    if not np.isfinite(probs).all():
                        raise FloatingPointError(
                            f"non-finite probabilities in predict batch "
                            f"{b_idx} (process {p}) — the model state is "
                            "degenerate; refusing to write a misaligned "
                            "output file"
                        )
                    payload = "".join(
                        f"{float(v):.6f}\n" for v in probs
                    ).encode()
                    assert len(payload) == row_bytes * valid, (
                        "fixed-width predict line invariant violated"
                    )
                    out_f.seek(row_bytes * (int(starts[p]) + base))
                    out_f.write(payload)
        finally:
            if out_f is not None:
                out_f.close()
        self._flush_eval_overflow("predict")
        return total

    @property
    def _eval_plain(self):
        if not hasattr(self, "_eval_plain_jit"):
            fmt = getattr(self, "_fmt", None)
            self._eval_plain_jit = jax.jit(
                self.model.eval_step,
                **(
                    {"in_shardings": (fmt, self._fmt_auto)}
                    if fmt is not None
                    else {}
                ),
            )
        return self._eval_plain_jit

    def save_checkpoint(self, path: str, extra: dict | None = None) -> None:
        """Full-state checkpoint; sharded states stream logical row chunks
        straight off the mesh (no full-table host gather).  Multi-host: only
        the coordinator writes."""
        from ftrl_ffm_tpu.io.checkpoint import model_signature, save_checkpoint

        # serialize behind any in-flight async mid-training save (same path)
        self._join_pending_checkpoint()
        # always persist the model-defining config: resume/import validates
        # it (validate_header_compat) before shapes can silently reinterpret
        extra = dict(extra or {})
        extra.setdefault("model_config", model_signature(self.cfg))

        self._maybe_sync_lin()
        state = self.state
        n_shards = self._sharded.n_shards if self._sharded else 1
        if self._proc_n > 1 and self._sharded is not None:
            # Multi-host meshes: the coordinator cannot stream-gather rows
            # of a non-fully-addressable table by itself — ALL processes
            # join the allgather (unshard_state), then only process 0
            # writes.  Single-host sharded states keep the streaming
            # per-chunk de-interleave (no full-table materialization).
            state = self.logical_state
            n_shards = 1
        if self._proc_id != 0:
            return
        save_checkpoint(
            path,
            state,
            level=self.cfg.compress_level,
            extra=extra,
            n_shards=n_shards,
            n_feats=self.cfg.n_feats,
        )

    def _join_pending_checkpoint(self) -> None:
        """Wait for the in-flight background checkpoint write (if any) and
        re-raise its failure loudly — a silently lost --save_every
        checkpoint would defeat the crash-recovery contract."""
        t = getattr(self, "_ckpt_thread", None)
        if t is not None:
            t.join()
            self._ckpt_thread = None
        exc = getattr(self, "_ckpt_exc", None)
        if exc is not None:
            self._ckpt_exc = None
            raise RuntimeError("background checkpoint write failed") from exc

    def _save_mid_checkpoint(self, step: int) -> None:
        """Periodic full-state checkpoint (new capability vs the reference,
        which has no mid-training checkpointing — SURVEY §5).

        With cfg.async_checkpoint (default) only the device→host snapshot
        happens inline — it is both the cheap part and required for
        correctness, since the next train step DONATES the state buffers —
        while zstd compression + file write run on a background thread
        overlapped with training (save_checkpoint's write is tmp+fsync+
        rename, so a crash mid-write never corrupts the previous
        checkpoint).  One save in flight at a time: a new save (or the
        final synchronous one) joins the previous first."""
        extra = {"mid_training_step": step}
        if not self.cfg.async_checkpoint:
            self.save_checkpoint(self.cfg.model_path, extra=extra)
            return
        import threading

        from ftrl_ffm_tpu.io.checkpoint import model_signature, save_checkpoint

        self._join_pending_checkpoint()
        extra["model_config"] = model_signature(self.cfg)
        self._maybe_sync_lin()
        state = self.state
        n_shards = self._sharded.n_shards if self._sharded else 1
        if self._proc_n > 1 and self._sharded is not None:
            # every process joins the allgather; only process 0 writes
            state = self.logical_state
            n_shards = 1
        if self._proc_id != 0:
            return
        # Snapshot: the next train step DONATES the state buffers, so the
        # values must be secured NOW.  When a device-side copy fits next to
        # everything resident, snapshot in device memory and let the
        # writer thread pull it to host — the device->host transfer leaves
        # the training thread entirely.  Otherwise (huge tables) fall back
        # to the inline device_get — correctness first.
        if self._proc_n == 1 and self._snapshot_copy_fits(state):
            snap = jax.tree.map(jnp.copy, state)
            jax.block_until_ready(jax.tree.leaves(snap)[0])
            host_state = None
        else:
            snap = None
            host_state = jax.device_get(state)
        path, level, n_feats = (
            self.cfg.model_path, self.cfg.compress_level, self.cfg.n_feats
        )

        def _write():
            try:
                hs = host_state if snap is None else jax.device_get(snap)
                save_checkpoint(
                    path, hs, level=level, extra=extra,
                    n_shards=n_shards, n_feats=n_feats,
                )
            except BaseException as e:  # surfaced at the next join
                self._ckpt_exc = e

        self._ckpt_thread = threading.Thread(
            target=_write, name="ftrl-ckpt-writer", daemon=True
        )
        self._ckpt_thread.start()

    def _snapshot_copy_fits(self, state) -> bool:
        """Can a full device-side copy of the state live next to the state
        itself, the device caches, and the update working set?  Conservative
        3x-state headroom (state + copy + in-flight update temps) against
        the 0.8 x device-memory budget (same budget as _device_cache_fits)."""
        cap = device_memory_bytes()
        if cap is None:
            return True
        st_b = sum(int(getattr(a, "nbytes", 0)) for a in jax.tree.leaves(state))
        cache_b = sum(
            int(getattr(a, "nbytes", 0))
            for c in self._dev_cache.values()
            if c is not None
            for a in jax.tree.leaves(c.ds)
        )
        return 3 * st_b + cache_b < 0.8 * cap

    def _note_eval_overflow(self, of) -> None:
        """Route-mode eval/predict drop accounting: lazily accumulate the
        per-batch overflow counter (a device scalar — no per-batch host
        sync) for end-of-pass enforcement (_flush_eval_overflow)."""
        if of is None:
            return
        pending = getattr(self, "_pending_eval_overflow", None)
        self._pending_eval_overflow = of if pending is None else pending + of

    def _flush_eval_overflow(self, where: str) -> int:
        """One readback at pass end: warn loudly / raise (per
        route_overflow_policy) if routed-bucket capacity dropped any
        occurrences — metrics/predictions would silently miss features
        (the eval twin of the train-path exactness guarantee)."""
        of_dev = getattr(self, "_pending_eval_overflow", None)
        self._pending_eval_overflow = None
        if of_dev is None:
            return 0
        of = int(jax.device_get(of_dev))
        if of:
            msg = (
                f"routed lookup dropped {of} occurrences during {where} "
                f"(bucket capacity): metrics/predictions computed with "
                f"missing features; raise --route_capacity"
            )
            if self._proc_id == 0:
                print(f"WARNING: {msg}")
            if self.cfg.route_overflow_policy == "error":
                raise RuntimeError(msg)
        return of

    def evaluate(self) -> tuple[float, float]:
        acc = LossAccumulator()
        auc = StreamingAUC(AUC_BINS)
        # auc_mode="exact": collect per-example (logit, y, w) device rows
        # and close the rank AUC host-side at pass end — for eval sets whose
        # scores fit host memory (12 B/example device + host).  binned stays
        # the O(1)-memory streaming default (error bound:
        # StreamingAUC.error_bound).
        exact = self.cfg.eval_auc and self.cfg.auc_mode == "exact"
        if exact and self._proc_n > 1:
            raise ValueError(
                "auc_mode=exact collects all scores on one host — use "
                "auc_mode=binned on multi-process runs"
            )
        if exact:
            self._ensure_exact_eval_steps()
        score_rows: list = []
        # Running device-side accumulation: O(1) device buffers and one
        # host readback (retaining per-batch result tuples held ~64 KB of
        # AUC histograms per batch alive for the whole pass).  Compensated
        # (Kahan) chaining keeps whole-pass f32 accumulation at O(1) ulps —
        # the reference's double accounting (metrics.py::kahan_add).
        tot = None

        def add(r):
            nonlocal tot
            if exact:
                part, rest = tuple(r[:2]), r[2:]
                score_rows.append(tuple(rest[:3]))
                of = rest[3] if len(rest) > 3 else None
            else:
                part = tuple(r[:4])
                of = r[4] if len(r) > 4 else None
            if tot is None:
                tot = (part, tuple(jnp.zeros_like(p) for p in part))
            else:
                tot = kahan_add(tot[0], tot[1], part)
            if of is not None:
                self._note_eval_overflow(of)

        cache = self._fresh_cache("eval")
        if exact and cache is not None and cache.layout == "shard":
            raise ValueError(
                "auc_mode=exact needs per-example scores; the shard-layout "
                "device cache reduces to histograms inside shard_map — use "
                "--device_cache_layout replicate or --auc_mode binned"
            )
        if cache is not None:
            ds_dev, n = cache.ds, cache.n
            if cache.layout == "shard":
                for row in self._cached_idx_shard(cache, None, False):
                    add(
                        self._sharded.gather_eval_auc_shard(
                            self.state,
                            ds_dev,
                            self._cached_row(cache, row),
                            cache.n_real_dev,
                        )
                    )
            elif self._spc > 1:
                n_arr = jnp.asarray(n, jnp.int32)
                for part, _ in self._cached_idx_chunks(n, np.arange(n)):
                    add(
                        self._gather_eval_multi(self.state, ds_dev, part, n_arr)
                    )
            elif (
                not exact
                and self._sharded is None
                and os.environ.get("FTRL_IOTA_REPLAY", "1") != "0"
            ):
                # eval is always identity-order: device-generated iota rows
                n_arr = jnp.asarray(n, jnp.int32)
                for s_i in range(-(-n // self._local_bs)):
                    add(
                        self._gather_eval_one_iota(
                            self.state,
                            ds_dev,
                            np.int32(s_i),
                            n_arr,
                        )
                    )
            else:
                gather = (
                    "_gather_eval_scores_one" if exact else "_gather_eval_one"
                )
                n_arr = jnp.asarray(n, jnp.int32)
                for row in self._cached_idx(n, np.arange(n)):
                    add(
                        getattr(self, gather)(self.state, ds_dev, row, n_arr)
                    )
        elif self._spc > 1:
            groups = self._grouped(self._eval_batches(), self._spc)
            for group, _ in self._device_feed_multi(groups, role="eval"):
                add(self._eval_multi(self.state, group))
        else:
            step = "_eval_scores_step" if exact else "_eval_step"
            for batch in self._device_feed(self._eval_batches(), role="eval"):
                add(getattr(self, step)(self.state, batch))
        self._agree_dyn("eval")
        if tot is None:
            self._flush_eval_overflow("eval")
            return float("nan"), float("nan")
        if exact:
            loss_sum, count = jax.device_get(tot[0])
            lg, yy, ww = jax.device_get(
                (
                    jnp.concatenate([r[0] for r in score_rows]),
                    jnp.concatenate([r[1] for r in score_rows]),
                    jnp.concatenate([r[2] for r in score_rows]),
                )
            )
            self._flush_eval_overflow("eval")
            acc.update(loss_sum, count)
            m = np.asarray(ww) > 0  # drop padding rows
            return acc.mean, exact_auc(
                np.asarray(lg)[m], np.asarray(yy)[m] > 0
            )
        loss_sum, count, pos, neg = jax.device_get(tot[0])
        self._flush_eval_overflow("eval")
        acc.update(loss_sum, count)
        auc.update(pos, neg)
        return acc.mean, auc.result()

    def train(self, profile_dir: Optional[str] = None) -> dict:
        """Full multi-epoch run; prints the reference's per-epoch lines
        (reference: src/task/ftrl_online.cpp:45-67).

        profile_dir: if set, epoch 1 runs under a jax.profiler trace — the
        device-level upgrade of the reference's steady-clock timers
        (src/include/utils/utils.h:89-104)."""
        cfg = self.cfg
        history = {
            "train_loss": [],
            "eval_loss": [],
            "eval_auc": [],
            "route_overflow": [],
        }
        rng = np.random.default_rng(cfg.seed)
        # multi-host: only the coordinator prints the reference-format lines
        log = print if self._proc_id == 0 else (lambda *a, **k: None)
        for epoch in range(1, cfg.n_epochs + 1):
            t0 = time.perf_counter()
            if profile_dir and epoch == 1:
                with jax.profiler.trace(profile_dir):
                    train_loss = self.train_epoch(rng)
                    jax.block_until_ready(self.state.lin_z)
            else:
                train_loss = self.train_epoch(rng)
            jax.block_until_ready(self.state.lin_z)
            dt = time.perf_counter() - t0
            log(
                f"epoch {epoch} train time: {dt:.4f}s, train loss: {train_loss:.4f}"
            )
            history["train_loss"].append(train_loss)
            overflow = getattr(self, "_epoch_route_overflow", 0)
            history["route_overflow"].append(overflow)
            if overflow:
                # the reference updates every occurrence of every sample
                # unconditionally (src/model/ftrl_model.cpp:66-77) — dropped
                # occurrences are an exactness violation and must be loud
                log(
                    f"epoch {epoch} WARNING: routed lookup dropped "
                    f"{overflow} occurrences (bucket capacity); raise "
                    f"--route_capacity for exact updates"
                )
                if cfg.route_overflow_policy == "error":
                    raise RuntimeError(
                        f"route-mode bucket overflow: {overflow} occurrences "
                        f"dropped in epoch {epoch} (route_overflow_policy="
                        f"'error'); raise route_capacity"
                    )
            if cfg.eval_data:
                t0 = time.perf_counter()
                eval_loss, eval_auc = self.evaluate()
                dt = time.perf_counter() - t0
                if cfg.eval_auc:
                    log(
                        f"epoch {epoch} eval time: {dt:.4f}s, "
                        f"eval loss: {eval_loss:.4f}, eval auc: {eval_auc:.4f}"
                    )
                else:
                    log(
                        f"epoch {epoch} eval time: {dt:.4f}s, eval loss: {eval_loss:.4f}"
                    )
                history["eval_loss"].append(eval_loss)
                history["eval_auc"].append(eval_auc)
        # don't return with a checkpoint still compressing in the background
        # (the daemon thread would die with the process); atomic rename makes
        # even a hard kill safe, but a clean exit must leave the file written
        self._join_pending_checkpoint()
        return history
