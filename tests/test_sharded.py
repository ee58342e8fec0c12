"""Sharded step ((data, model) mesh) must match the single-device step.

Runs on the virtual 8-device CPU mesh from conftest.py — the accelerator-free
equivalent of a multi-chip slice (SURVEY §4's "new" multi-host test tier).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ftrl_ffm_tpu.config import Config
from ftrl_ffm_tpu.models import Batch, make_model
from ftrl_ffm_tpu.parallel import ShardedStep, make_mesh, shard_state, unshard_state


def _random_batch(rng, b, f, n_feats, n_fields, pad_tail=2):
    fields = rng.integers(0, n_fields, (b, f)).astype(np.int32)
    feats = rng.integers(0, n_feats, (b, f)).astype(np.int32)
    vals = rng.random((b, f)).astype(np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    sample_w = np.ones(b, np.float32)
    # inert padding occurrences + padded samples, like real batches
    feats[:, -1] = n_feats
    vals[:, -1] = 0.0
    fields[:, -1] = 0
    if pad_tail:
        sample_w[-pad_tail:] = 0.0
        vals[-pad_tail:] = 0.0
        feats[-pad_tail:] = n_feats
        y[-pad_tail:] = 0.0
    return (fields, feats, vals, y, sample_w)


def _cfg(model_type, **kw):
    return Config(
        model_type=model_type,
        n_feats=50,
        n_fields=4,
        n_factors=4,
        batch_size=16,
        max_nnz=5,
        **kw,
    )


@pytest.mark.parametrize("model_type", ["LR", "FM", "FFM"])
@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
@pytest.mark.parametrize("lookup_mode", ["replicate", "route"])
def test_sharded_matches_single_device(model_type, mesh_shape, lookup_mode):
    if lookup_mode == "route" and mesh_shape[1] == 1:
        pytest.skip("route degenerates to replicate at mesh_model=1")
    cfg = _cfg(model_type, lookup_mode=lookup_mode)
    model = make_model(cfg)
    state0 = model.init()
    rng = np.random.default_rng(0)
    arrays = _random_batch(rng, cfg.batch_size, cfg.max_nnz, cfg.n_feats, cfg.n_fields)
    batch = Batch(*(jnp.asarray(a) for a in arrays))

    # single-device ground truth, two steps
    out1 = model.train_step(state0, batch)
    out2 = model.train_step(out1.state, batch)

    mesh = make_mesh(*mesh_shape)
    sstate = shard_state(model.init(), mesh)
    step = ShardedStep(cfg, mesh, sstate)
    sbatch = step.place_batch(arrays)
    sstate, logits, loss_sum, count, _ = step.train_step(sstate, sbatch)
    np.testing.assert_allclose(
        np.asarray(logits), np.asarray(out1.logits), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        float(loss_sum), float(out1.loss_sum), rtol=1e-5
    )
    assert float(count) == float(out1.count)
    sstate, logits, loss_sum, count, _ = step.train_step(sstate, sbatch)

    lstate = unshard_state(sstate, mesh.shape["model"], cfg.n_feats)
    np.testing.assert_allclose(
        np.asarray(lstate.lin_z), np.asarray(out2.state.lin_z), rtol=1e-4, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(lstate.lin_n), np.asarray(out2.state.lin_n), rtol=1e-4, atol=1e-7
    )
    np.testing.assert_allclose(
        float(lstate.bias_z), float(out2.state.bias_z), rtol=1e-5
    )
    if model_type != "LR":
        np.testing.assert_allclose(
            np.asarray(lstate.vec_z),
            np.asarray(out2.state.vec_z),
            rtol=1e-4,
            atol=1e-7,
        )
    np.testing.assert_allclose(
        np.asarray(logits), np.asarray(out2.logits), rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("model_type", ["FFM"])
def test_sharded_eval_matches(model_type):
    cfg = _cfg(model_type)
    model = make_model(cfg)
    state0 = model.init()
    rng = np.random.default_rng(1)
    arrays = _random_batch(rng, cfg.batch_size, cfg.max_nnz, cfg.n_feats, cfg.n_fields)
    batch = Batch(*(jnp.asarray(a) for a in arrays))
    loss_sum, count, logits = model.eval_step(state0, batch)

    mesh = make_mesh(4, 2)
    sstate = shard_state(model.init(), mesh)
    step = ShardedStep(cfg, mesh, sstate)
    sloss, scount, slogits, _ = step.eval_step(sstate, step.place_batch(arrays))
    np.testing.assert_allclose(float(sloss), float(loss_sum), rtol=1e-5)
    assert float(scount) == float(count)
    np.testing.assert_allclose(
        np.asarray(slogits), np.asarray(logits), rtol=1e-5, atol=1e-6
    )


def test_trainer_with_mesh_matches_single_device(tmp_path):
    """End-to-end Trainer parity: (4 data x 2 model) mesh vs single device."""
    import copy
    from ftrl_ffm_tpu.train import Trainer

    # small synthetic libffm file
    rng = np.random.default_rng(0)
    lines = []
    for i in range(256):
        toks = [str(int(rng.random() > 0.5))] + [
            f"{c}:{int(rng.integers(0, 50))}:1" for c in range(4)
        ]
        lines.append(" ".join(toks))
    path = str(tmp_path / "train.ffm")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")

    kw = dict(
        train_data=path, eval_data=path, model_type="FFM", n_fields=4,
        n_feats=50, n_factors=4, batch_size=64, n_epochs=1, online=True,
    )
    t1 = Trainer(Config(**kw))
    h1 = t1.train()
    t2 = Trainer(Config(**kw, mesh_data=4, mesh_model=2))
    h2 = t2.train()
    np.testing.assert_allclose(h1["train_loss"], h2["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(h1["eval_loss"], h2["eval_loss"], rtol=1e-5)
    np.testing.assert_allclose(h1["eval_auc"], h2["eval_auc"], rtol=1e-4)


@pytest.mark.parametrize("model_type", ["LR", "FFM"])
def test_sharded_sparse_update_matches_single_device(model_type):
    """update_mode=sparse: all_gather (id, g) stream + touched-rows update
    must equal the single-device sparse step."""
    cfg = _cfg(model_type, update_mode="sparse", lookup_mode="replicate")
    model = make_model(cfg)
    rng = np.random.default_rng(4)
    arrays = _random_batch(rng, cfg.batch_size, cfg.max_nnz, cfg.n_feats, cfg.n_fields)
    batch = Batch(*(jnp.asarray(a) for a in arrays))
    out1 = model.train_step(model.init(), batch)

    mesh = make_mesh(4, 2)
    sstate = shard_state(model.init(), mesh)
    step = ShardedStep(cfg, mesh, sstate)
    sstate, logits, loss_sum, count, _ = step.train_step(sstate, step.place_batch(arrays))
    lstate = unshard_state(sstate, mesh.shape["model"], cfg.n_feats)
    np.testing.assert_allclose(
        np.asarray(lstate.lin_z), np.asarray(out1.state.lin_z), rtol=1e-4, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(logits), np.asarray(out1.logits), rtol=1e-5, atol=1e-6
    )
    if model_type != "LR":
        np.testing.assert_allclose(
            np.asarray(lstate.vec_z), np.asarray(out1.state.vec_z),
            rtol=1e-4, atol=1e-7,
        )


@pytest.mark.parametrize("model_type", ["FM", "FFM"])
def test_route_inplace_update_matches_single_device(model_type):
    """Huge-shard route mode on a (1, N) mesh takes the in-place update
    (z-scatter + single accumulator + closed-form pass) instead of the
    dense [rows_local, 2D] accumulator — must equal the single-device
    step."""
    cfg = _cfg(model_type, lookup_mode="route", update_mode="inplace")
    model = make_model(cfg)
    rng = np.random.default_rng(21)
    arrays = _random_batch(rng, cfg.batch_size, cfg.max_nnz, cfg.n_feats,
                           cfg.n_fields)
    batch = Batch(*(jnp.asarray(a) for a in arrays))
    out1 = model.train_step(model.init(), batch)

    mesh = make_mesh(1, 8)
    sstate = shard_state(model.init(), mesh)
    step = ShardedStep(cfg, mesh, sstate)
    assert step.mode == "route"
    sstate, logits, loss_sum, count, of = step.train_step(
        sstate, step.place_batch(arrays)
    )
    assert int(of) == 0
    lstate = unshard_state(sstate, 8, cfg.n_feats)
    np.testing.assert_allclose(
        np.asarray(logits), np.asarray(out1.logits), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(lstate.vec_z), np.asarray(out1.state.vec_z),
        rtol=1e-4, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(lstate.vec_n), np.asarray(out1.state.vec_n),
        rtol=1e-4, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(lstate.lin_z), np.asarray(out1.state.lin_z),
        rtol=1e-4, atol=1e-7,
    )


@pytest.mark.parametrize("model_type", ["FM", "FFM"])
def test_route_sparse2_takes_inplace_form_and_matches(model_type):
    """Shards in the sparse2 regime (beyond the in-place accumulator
    budget) on the (1, N) routed path must take the in-place update too —
    the dense [rows_local, 2D] fall-through is twice the footprint the
    in-place branch exists to avoid (ADVICE r3).  Semantics identical."""
    cfg = _cfg(model_type, lookup_mode="route", update_mode="sparse")
    model = make_model(cfg)
    rng = np.random.default_rng(33)
    arrays = _random_batch(rng, cfg.batch_size, cfg.max_nnz, cfg.n_feats,
                           cfg.n_fields)
    batch = Batch(*(jnp.asarray(a) for a in arrays))
    out1 = model.train_step(model.init(), batch)

    mesh = make_mesh(1, 8)
    sstate = shard_state(model.init(), mesh)
    step = ShardedStep(cfg, mesh, sstate)
    assert step.mode == "route"
    sstate, logits, loss_sum, count, of = step.train_step(
        sstate, step.place_batch(arrays)
    )
    assert int(of) == 0
    lstate = unshard_state(sstate, 8, cfg.n_feats)
    np.testing.assert_allclose(
        np.asarray(logits), np.asarray(out1.logits), rtol=1e-5, atol=1e-6
    )
    for name in ("vec_z", "vec_n", "lin_z", "lin_n"):
        np.testing.assert_allclose(
            np.asarray(getattr(lstate, name)),
            np.asarray(getattr(out1.state, name)),
            rtol=1e-4, atol=1e-7, err_msg=name,
        )


def test_route_hot_id_exact_even_at_tiny_capacity():
    """Unique-id routing makes duplicate-id skew incapable of overflow: a
    batch where EVERY occurrence is the same id (the pathological hot-key
    case that overflowed occurrence-slot routing) trains exactly, matching
    the single-device step, even at route_capacity=0.01."""
    cfg = _cfg("LR", lookup_mode="route", route_capacity=0.01)
    model = make_model(cfg)
    rng = np.random.default_rng(7)
    arrays = _random_batch(rng, cfg.batch_size, cfg.max_nnz, cfg.n_feats, cfg.n_fields,
                           pad_tail=0)
    # every occurrence the same id -> one unique id -> one slot, no overflow
    arrays = (arrays[0], np.full_like(arrays[1], 3), arrays[2], arrays[3], arrays[4])

    out1 = model.train_step(model.init(), Batch(*(jnp.asarray(a) for a in arrays)))

    mesh = make_mesh(2, 4)
    sstate = shard_state(model.init(), mesh)
    step = ShardedStep(cfg, mesh, sstate)
    assert step.mode == "route" and step.route_k == 8  # clamped minimum
    out = step.train_step(sstate, step.place_batch(arrays))
    assert int(out.route_overflow) == 0
    lstate = unshard_state(out.state, 4, cfg.n_feats)
    np.testing.assert_allclose(
        np.asarray(lstate.lin_z), np.asarray(out1.state.lin_z),
        rtol=1e-4, atol=1e-7,
    )
    np.testing.assert_allclose(
        float(out.loss_sum), float(out1.loss_sum), rtol=1e-5
    )


def _zipf_batch(rng, b, f, n_feats, n_fields, s=1.1):
    """Heavy-tailed (Zipf s~1.1) feature ids — the realistic CTR id
    distribution that stressed occurrence-slot routing."""
    ranks = rng.zipf(s, size=(b, f))
    feats = np.minimum(ranks - 1, n_feats - 1).astype(np.int32)
    fields = rng.integers(0, n_fields, (b, f)).astype(np.int32)
    vals = np.ones((b, f), np.float32)
    y = (rng.random(b) > 0.5).astype(np.float32)
    return (fields, feats, vals, y, np.ones(b, np.float32))


@pytest.mark.parametrize("model_type", ["LR", "FFM"])
def test_route_zipf_skew_exact_at_default_capacity(model_type):
    """On Zipf-skewed (s=1.1) ids at
    the DEFAULT route_capacity, route-mode losses/state equal the
    replicate-mode (exact) ones and zero occurrences are dropped —
    matching the reference's unconditional per-occurrence updates
    (src/model/ftrl_model.cpp:66-77)."""
    cfg_route = _cfg(model_type, lookup_mode="route")
    cfg_repl = _cfg(model_type, lookup_mode="replicate")
    rng = np.random.default_rng(11)
    arrays = _zipf_batch(rng, cfg_route.batch_size, cfg_route.max_nnz,
                         cfg_route.n_feats, cfg_route.n_fields)

    model = make_model(cfg_repl)
    mesh = make_mesh(4, 2)

    sstate_r = shard_state(model.init(), mesh)
    step_r = ShardedStep(cfg_repl, mesh, sstate_r)
    sb_r = step_r.place_batch(arrays)
    ref_state, _, ref_loss, _, _ = step_r.train_step(sstate_r, sb_r)
    ref_state, _, ref_loss2, _, _ = step_r.train_step(ref_state, sb_r)

    sstate = shard_state(make_model(cfg_route).init(), mesh)
    step = ShardedStep(cfg_route, mesh, sstate)
    assert step.mode == "route"
    sb = step.place_batch(arrays)
    out = step.train_step(sstate, sb)
    assert int(out.route_overflow) == 0
    np.testing.assert_allclose(float(out.loss_sum), float(ref_loss), rtol=1e-5)
    out = step.train_step(out.state, sb)
    assert int(out.route_overflow) == 0
    np.testing.assert_allclose(float(out.loss_sum), float(ref_loss2), rtol=1e-5)

    l_route = unshard_state(out.state, 2, cfg_route.n_feats)
    l_repl = unshard_state(ref_state, 2, cfg_route.n_feats)
    np.testing.assert_allclose(
        np.asarray(l_route.lin_z), np.asarray(l_repl.lin_z),
        rtol=1e-4, atol=1e-7,
    )
    if model_type != "LR":
        np.testing.assert_allclose(
            np.asarray(l_route.vec_z), np.asarray(l_repl.vec_z),
            rtol=1e-4, atol=1e-7,
        )


def test_route_distinct_id_overflow_counted_and_graceful():
    """The residual adversarial case: more DISTINCT ids owned by one peer
    than route_k.  Dropped occurrences are counted (TrainOut.route_overflow)
    and the step stays finite; ids that fit still update."""
    m = 4
    cfg = Config(
        model_type="LR", n_feats=64, n_fields=4, batch_size=16, max_nnz=5,
        lookup_mode="route", route_capacity=0.01,
    )
    model = make_model(cfg)
    rng = np.random.default_rng(9)
    arrays = _random_batch(rng, cfg.batch_size, cfg.max_nnz, cfg.n_feats,
                           cfg.n_fields, pad_tail=0)
    # 16 distinct logical ids that all live on shard 0 (physical ids are
    # modulo-interleaved: logical id l -> shard l % m).  On the (1, 4) mesh
    # each device holds 4 samples = 20 occurrences cycling through all 16
    # distinct ids -> per-device demand 16 > k = 8, overflow guaranteed.
    b, f = arrays[1].shape
    feats = (m * (np.arange(b * f) % 16)).reshape(b, f).astype(np.int32)
    arrays = (arrays[0], feats, arrays[2], arrays[3], arrays[4])

    mesh = make_mesh(1, m)
    sstate = shard_state(model.init(), mesh)
    step = ShardedStep(cfg, mesh, sstate)
    assert step.route_k == 8
    out = step.train_step(sstate, step.place_batch(arrays))
    assert np.isfinite(float(out.loss_sum))
    assert int(out.route_overflow) > 0
    z = np.asarray(unshard_state(out.state, m, cfg.n_feats).lin_z)
    touched = np.flatnonzero(z)
    assert len(touched) > 0  # ids that fit still updated
    assert np.all(touched % m == 0)  # only shard-0 ids were in the batch


def test_route_overflow_policy_error_raises(tmp_path):
    """Trainer surfaces the per-epoch drop counter in history and raises
    under route_overflow_policy='error'."""
    from ftrl_ffm_tpu.train import Trainer
    from ftrl_ffm_tpu.config import Config

    rng = np.random.default_rng(13)
    path = str(tmp_path / "t.ffm")
    m = 4
    with open(path, "w") as f:
        for i in range(64):
            # adversarial: all ids on shard 0 (≡ 0 mod m), lines cycle
            # through 16 distinct ids so each device's 4-sample slice
            # demands 16 slots > k = 8
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{m * ((4 * i + c) % 16)}:1" for c in range(4)
            ]
            f.write(" ".join(toks) + "\n")
    kw = dict(
        train_data=path, model_type="LR", n_fields=4, n_feats=64,
        batch_size=16, n_epochs=1, online=True, mesh_data=1, mesh_model=m,
        lookup_mode="route", route_capacity=0.01,
    )
    tr = Trainer(Config(**kw))
    h = tr.train()
    assert h["route_overflow"][0] > 0  # counted and surfaced
    with pytest.raises(RuntimeError, match="bucket overflow"):
        Trainer(Config(**kw, route_overflow_policy="error")).train()


# -------------------------------------- HLO machine-check of the scaling model
def _compiled_collectives(cfg, mesh_shape):
    """Lower + compile the sharded train step and extract every collective
    from the optimized HLO: (kind, total_bytes, communicates) where
    `communicates` is False for singleton replica groups (no traffic —
    e.g. a psum over a size-1 mesh axis)."""
    import re

    model = make_model(cfg)
    mesh = make_mesh(*mesh_shape)
    sstate = shard_state(model.init(), mesh)
    step = ShardedStep(cfg, mesh, sstate)
    rng = np.random.default_rng(0)
    b, f = cfg.batch_size, cfg.max_nnz
    arrays = (
        rng.integers(0, cfg.n_fields, (b, f)).astype(np.int32),
        rng.integers(0, cfg.n_feats, (b, f)).astype(np.int32),
        np.ones((b, f), np.float32),
        (rng.random(b) > 0.5).astype(np.float32),
        np.ones(b, np.float32),
    )
    txt = step.train_step.lower(
        sstate, step.place_batch(arrays)
    ).compile().as_text()
    dt_bytes = {"f32": 4, "s32": 4, "u32": 4, "pred": 1, "bf16": 2,
                "u16": 2, "s8": 1, "u8": 1, "f64": 8, "s64": 8, "u64": 8}
    shape_re = re.compile(r"(\w+)\[([0-9,]*)\]")
    out = []
    for line in txt.splitlines():
        # result type is either one shape or a tuple "(f32[...], ...)" —
        # tuples embed /*index=N*/ comments, so the capture must allow '='
        m = re.search(
            r"=\s*(\([^)]*\)|\w+\[[0-9,]*\]\S*)\s+(all-to-all|all-reduce"
            r"|all-gather|reduce-scatter|collective-permute)\(",
            line,
        )
        if not m:
            continue
        shapes_txt, kind = m.groups()
        nbytes = 0
        for dt, dims in shape_re.findall(shapes_txt):
            if dt not in dt_bytes:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * dt_bytes[dt]
        g = re.search(r"replica_groups=\{(.*?)\}\s*,", line)
        communicates = True
        if g:
            groups = re.findall(r"\{([0-9,]+)\}", "{" + g.group(1) + "}")
            communicates = any("," in grp for grp in groups)
        out.append((kind, nbytes, communicates))
    return step, out


def test_route_mesh_has_no_table_sized_collective():
    """The compiled (1, N) route step must have NO
    communicating collective of O(rows_local * E) — the structural claim
    behind tools/scaling_model.py's '(1, N) meshes have no O(R) ICI leg'.
    All-to-all volume must equal the occurrence-proportional route-buffer
    sizes exactly."""
    cfg = Config(model_type="FFM", n_feats=8192, n_fields=4, n_factors=4,
                 batch_size=64, max_nnz=4, lookup_mode="route")
    step, cols = _compiled_collectives(cfg, (1, 8))
    assert step.mode == "route"
    e = cfg.row_width
    table_bytes = step.rows_local * e * 4
    comm = [(k, b) for k, b, c in cols if c]
    assert comm, "no communicating collectives found — HLO parse broke?"
    for kind, nbytes in comm:
        assert nbytes < table_bytes, (
            f"{kind} moves {nbytes} B >= O(rows_local*E) {table_bytes} B — "
            "an O(table) collective on the recommended scaling shape"
        )
    # a2a volume == the route buffers exactly: ids [M*K] s32, lin rows
    # [M*K] f32, factor rows [M*K, E], lin payload [M*K, 2], factor
    # payload [M*K, 2E] (parallel/sharded.py::_route/_routed_rows/
    # _table_update_routed)
    mk = step.n_shards * step.route_k
    expected_a2a = mk * 4 * (1 + 1 + e + 2 + 2 * e)
    a2a_total = sum(b for k, b, c in cols if k == "all-to-all" and c)
    assert a2a_total == expected_a2a, (
        f"a2a bytes {a2a_total} != modeled route volume {expected_a2a}"
    )
    # and the table-sized linear-accumulator psum must be traffic-free
    # (singleton groups) on mesh_data=1
    non_comm_big = [b for k, b, c in cols if not c]
    assert all(b <= step.rows_local * 2 * 4 for b in non_comm_big)


def test_hybrid_mesh_accumulator_allreduce_matches_scaling_model():
    """The (D, M) hybrid's dense2-regime step must carry
    a communicating all-reduce of EXACTLY the scaling model's O(R/M)
    volume term (tools/scaling_model.py::model_step's psum_acc leg:
    r_loc * 2E * 4 bytes) — the leg that forbids D > 1 at production
    table sizes."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "scaling_model",
        os.path.join(os.path.dirname(__file__), "..", "tools",
                     "scaling_model.py"),
    )
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)

    # C=39, K=16: Config.field_pad (40) == the model's padded width, so the
    # HLO volume and the model term must agree to the byte
    cfg = Config(model_type="FFM", n_feats=512, n_fields=39, n_factors=16,
                 batch_size=64, max_nnz=4, lookup_mode="replicate",
                 update_mode="dense")
    d, m = 4, 2
    step, cols = _compiled_collectives(cfg, (d, m))
    r_loc = cfg.n_feats // m
    e = cfg.row_width
    assert e == 40 * 16  # field_pad alignment: matches the model's cp * k
    model_term_bytes = int(r_loc * 2 * e * 4)
    # cross-check the expression against model_step itself: its psum_acc
    # time is ring_factor * volume / ici
    ici = 45e9
    t = sm.model_step(d, m, cfg.batch_size // (d * m) * cfg.max_nnz
                      // cfg.max_nnz, cfg.n_fields, cfg.n_factors,
                      cfg.n_feats, 45.0)
    ring = 2 * (d - 1) / d
    assert abs(t["psum_acc_ms"] / 1e3 - ring * model_term_bytes / ici) < 1e-12
    comm_ar = [b for k, b, c in cols if k == "all-reduce" and c]
    assert comm_ar, "no communicating all-reduce found — HLO parse broke?"
    # XLA's all-reduce combiner merges the [R/M, 2] linear accumulator and
    # the loss scalars into the same op (+2 KB here): the dominant op's
    # volume must be the model term to within 1%
    big = max(comm_ar)
    assert model_term_bytes <= big <= model_term_bytes * 1.01, (
        f"dominant communicating all-reduce is {big} B; the scaling "
        f"model's [R/M, 2E] accumulator term is {model_term_bytes} B"
    )


def test_dec6_vals_on_mesh_matches_single_device(tmp_path):
    """The DEC6 vals tier (uint8 [B, 3F] fixed-point upload) is reachable
    from the single-process sharded path — vals stay batch-sharded, so the
    tier must not change numerics on a mesh either."""
    from ftrl_ffm_tpu.train import Trainer

    rng = np.random.default_rng(4)
    path = str(tmp_path / "dec.ffm")
    with open(path, "w") as f:
        for i in range(128):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 50))}"
                f":{int(rng.integers(1, 10**6)) / 10**6:.6f}"
                for c in range(4)
            ]
            f.write(" ".join(toks) + "\n")
    kw = dict(
        train_data=path, eval_data=path, model_type="FFM", n_fields=4,
        n_feats=50, n_factors=4, batch_size=32, n_epochs=1, online=True,
        device_cache="off",
    )
    t1 = Trainer(Config(**kw))
    h1 = t1.train()
    assert t1._dec6_ok, "decimal data must keep the DEC6 tier engaged"
    t2 = Trainer(Config(**kw, mesh_data=2, mesh_model=2))
    b = next(iter(t2._train_batches(np.random.default_rng(0))))
    c = t2._compact(b)
    assert c[2].dtype == np.uint8 and c[2].shape[-1] == 12  # tier engaged
    h2 = t2.train()
    np.testing.assert_allclose(h1["train_loss"], h2["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(h1["eval_loss"], h2["eval_loss"], rtol=1e-5)
