"""Serialization tests: full checkpoints, reference-compatible blobs, CLI."""

import numpy as np
import pytest

from ftrl_ffm_tpu.config import Config
from ftrl_ffm_tpu.io.checkpoint import (
    export_reference_model,
    export_reference_text_model,
    import_reference_model,
    import_reference_text_model,
    load_checkpoint,
    save_checkpoint,
)
from ftrl_ffm_tpu.models import make_model
from tests.test_models import make_batch, random_samples

N_FEATS, N_FIELDS, K = 50, 4, 3


def _trained_state(model_type="FFM", steps=5):
    cfg = Config(
        model_type=model_type, n_feats=N_FEATS, n_fields=N_FIELDS, n_factors=K
    )
    model = make_model(cfg)
    state = model.init()
    rng = np.random.default_rng(0)
    for _ in range(steps):
        batch = make_batch(random_samples(rng, 8), 6, N_FEATS, batch_size=8)
        state = model.train_step(state, batch).state
    return model, state


def test_full_checkpoint_roundtrip(tmp_path):
    model, state = _trained_state("FFM")
    path = str(tmp_path / "ckpt.zst")
    save_checkpoint(path, state, extra={"note": "hi"})
    loaded, extra = load_checkpoint(path)
    assert extra == {"note": "hi"}
    for a, b in zip(state, loaded):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_resume_training_is_exact(tmp_path):
    """Full (n, z, w) state means resume == uninterrupted training — the
    capability the reference lacks (it saves weights only, SURVEY §5)."""
    cfg = Config(model_type="FM", n_feats=N_FEATS, n_fields=N_FIELDS, n_factors=K)
    model = make_model(cfg)
    rng = np.random.default_rng(1)
    batches = [
        make_batch(random_samples(rng, 8), 6, N_FEATS, batch_size=8)
        for _ in range(6)
    ]
    s = model.init()
    for b in batches[:3]:
        s = model.train_step(s, b).state
    path = str(tmp_path / "mid.zst")
    save_checkpoint(path, s)
    s_resume, _ = load_checkpoint(path)
    for b in batches[3:]:
        s = model.train_step(s, b).state
        s_resume = model.train_step(s_resume, b).state
    np.testing.assert_array_equal(np.asarray(s.lin_z), np.asarray(s_resume.lin_z))
    np.testing.assert_array_equal(np.asarray(s.vec_z), np.asarray(s_resume.vec_z))


def test_lr_checkpoint_roundtrip(tmp_path):
    model, state = _trained_state("LR")
    path = str(tmp_path / "lr.zst")
    save_checkpoint(path, state)
    loaded, _ = load_checkpoint(path)
    assert loaded.vec_n is None and loaded.vec_w is None
    np.testing.assert_array_equal(np.asarray(state.lin_z), np.asarray(loaded.lin_z))


def test_reference_blob_roundtrip(tmp_path):
    """zstd [bias, lin_w..., vec_w...] blob — byte layout of the reference's
    compress_weights (src/compression/compress.cpp:15-27,
    src/model/ffm.cpp:138-159)."""
    model, state = _trained_state("FFM")
    bias, lin_w, vec_w = model.materialize_weights(state)
    path = str(tmp_path / "model.zst")
    export_reference_model(path, float(bias), lin_w, vec_w)
    b2, l2, v2 = import_reference_model(path, N_FEATS, N_FIELDS * K)
    assert b2 == pytest.approx(float(bias), abs=1e-7)
    np.testing.assert_allclose(np.asarray(lin_w), l2, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(vec_w).reshape(N_FEATS, -1), v2, rtol=1e-6
    )


def test_reference_text_roundtrip(tmp_path):
    """FFM plain-text layout (src/model/ffm.cpp:161-200)."""
    model, state = _trained_state("FFM")
    bias, lin_w, vec_w = model.materialize_weights(state)
    path = str(tmp_path / "model.txt")
    export_reference_text_model(path, float(bias), lin_w, vec_w)
    b2, l2, v2 = import_reference_text_model(path, N_FEATS, N_FIELDS * K)
    assert b2 == pytest.approx(float(bias), abs=1e-6)
    np.testing.assert_allclose(np.asarray(lin_w), l2, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(vec_w), v2, rtol=1e-5, atol=1e-7)


# ----------------------------------------------------------------------- CLI
def _write_ffm_file(path, n=64, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, N_FEATS))}:1" for c in range(N_FIELDS)
            ]
            f.write(" ".join(toks) + "\n")


def test_cli_end_to_end_with_checkpoint(tmp_path, capsys):
    from ftrl_ffm_tpu.cli import main

    data = str(tmp_path / "train.ffm")
    _write_ffm_file(data)
    ckpt = str(tmp_path / "model.ckpt")
    ref = str(tmp_path / "model.zst")
    rc = main([
        "--train_data", data, "--eval_data", data,
        "--model_type", "FFM", "--n_fields", str(N_FIELDS),
        "--n_feats", str(N_FEATS), "--n_factors", str(K),
        "--n_epochs", "2", "--batch_size", "32",
        "--model_path", ckpt, "--export_reference_model", ref,
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "epoch 1 train time" in out and "eval loss" in out
    state, extra = load_checkpoint(ckpt)
    assert int(state.step) == 4  # 64 samples / 32 batch * 2 epochs
    assert extra["config"]["model_type"] == "FFM"
    b2, l2, v2 = import_reference_model(ref, N_FEATS, N_FIELDS * K)
    assert l2.shape == (N_FEATS,)

    # resume from the checkpoint
    rc = main([
        "--train_data", data, "--model_type", "FFM",
        "--n_fields", str(N_FIELDS), "--n_feats", str(N_FEATS),
        "--n_factors", str(K), "--batch_size", "32",
        "--load_model", ckpt,
    ])
    assert rc == 0
    assert "resumed" in capsys.readouterr().out


def test_cli_predict_output(tmp_path, capsys):
    from ftrl_ffm_tpu.cli import main

    data = str(tmp_path / "train.ffm")
    _write_ffm_file(data, n=50)
    out = str(tmp_path / "preds.txt")
    rc = main([
        "--train_data", data, "--model_type", "FFM",
        "--n_fields", str(N_FIELDS), "--n_feats", str(N_FEATS),
        "--n_factors", str(K), "--batch_size", "16",
        "--predict_data", data, "--predict_output", out,
    ])
    assert rc == 0
    preds = [float(x) for x in open(out)]
    assert len(preds) == 50
    assert all(0.0 < p < 1.0 for p in preds)


def test_sharded_checkpoint_streams_logical_rows(tmp_path):
    """A checkpoint written from a (2, 4)-mesh state (physical interleaved
    rows, streamed chunk-wise — no full-table host gather) must equal the
    single-device state and resume exactly on any mesh."""
    import jax.numpy as jnp

    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.io.checkpoint import CHUNK_BYTES, save_checkpoint
    from ftrl_ffm_tpu.models import Batch, make_model
    from ftrl_ffm_tpu.parallel import ShardedStep, make_mesh, shard_state

    cfg = Config(model_type="FFM", n_feats=50, n_fields=4, n_factors=4,
                 batch_size=16, max_nnz=5)
    model = make_model(cfg)
    rng = np.random.default_rng(3)
    arrays = (
        rng.integers(0, 4, (16, 5)).astype(np.int32),
        rng.integers(0, 50, (16, 5)).astype(np.int32),
        rng.random((16, 5)).astype(np.float32),
        (rng.random(16) > 0.5).astype(np.float32),
        np.ones(16, np.float32),
    )
    batch = Batch(*(jnp.asarray(a) for a in arrays))
    ref = model.train_step(model.init(), batch)

    mesh = make_mesh(2, 4)
    sstate = shard_state(model.init(), mesh)
    step = ShardedStep(cfg, mesh, sstate)
    sstate, *_ = step.train_step(sstate, step.place_batch(arrays))

    path = str(tmp_path / "sharded.ckpt")
    # tiny chunk size to force the multi-chunk streaming path
    import ftrl_ffm_tpu.io.checkpoint as ck
    old = ck.CHUNK_BYTES
    ck.CHUNK_BYTES = 256
    try:
        save_checkpoint(path, sstate, n_shards=4, n_feats=cfg.n_feats)
    finally:
        ck.CHUNK_BYTES = old

    loaded, _ = load_checkpoint(path)
    assert loaded.lin_z.shape == (cfg.n_feats,)
    np.testing.assert_allclose(
        np.asarray(loaded.lin_z), np.asarray(ref.state.lin_z), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(loaded.vec_z), np.asarray(ref.state.vec_z), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(loaded.vec_w), np.asarray(ref.state.vec_w), rtol=1e-5, atol=1e-6
    )

    # resume on a different mesh: second step must match single-device
    ref2 = model.train_step(ref.state, batch)
    mesh2 = make_mesh(4, 2)
    s2 = shard_state(loaded, mesh2)
    step2 = ShardedStep(cfg, mesh2, s2)
    s2, _, loss2, _, _ = step2.train_step(s2, step2.place_batch(arrays))
    np.testing.assert_allclose(float(loss2), float(ref2.loss_sum), rtol=1e-5)


def test_cli_serve_only_predict_and_eval(tmp_path, capsys):
    """--load_model + --predict_data/--eval_data without --train_data:
    the serving/eval-only entry path (new vs the reference, whose main can
    only train)."""
    from ftrl_ffm_tpu.cli import main

    data = str(tmp_path / "train.ffm")
    _write_ffm_file(data, n=64)
    ckpt = str(tmp_path / "model.ckpt")
    assert main([
        "--train_data", data, "--model_type", "FFM",
        "--n_fields", str(N_FIELDS), "--n_feats", str(N_FEATS),
        "--n_factors", str(K), "--batch_size", "32",
        "--model_path", ckpt,
    ]) == 0
    capsys.readouterr()

    out = str(tmp_path / "preds.txt")
    rc = main([
        "--model_type", "FFM", "--n_fields", str(N_FIELDS),
        "--n_feats", str(N_FEATS), "--n_factors", str(K),
        "--batch_size", "16", "--load_model", ckpt,
        "--predict_data", data, "--predict_output", out,
    ])
    assert rc == 0
    assert len(open(out).readlines()) == 64

    rc = main([
        "--model_type", "FFM", "--n_fields", str(N_FIELDS),
        "--n_feats", str(N_FEATS), "--n_factors", str(K),
        "--batch_size", "16", "--load_model", ckpt,
        "--eval_data", data,
    ])
    assert rc == 0
    assert "eval loss:" in capsys.readouterr().out


def test_bfloat16_table_dtype_trains(tmp_path):
    """table_dtype=bfloat16 (halved factor-table gather/scatter HBM
    traffic): trains, loss stays close to the f32 run, state round-trips
    through a checkpoint."""
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer
    import jax.numpy as jnp

    data = str(tmp_path / "train.ffm")
    _write_ffm_file(data, n=256)
    kw = dict(train_data=data, model_type="FFM", n_fields=N_FIELDS,
              n_feats=N_FEATS, n_factors=K, batch_size=32, n_epochs=2,
              w_alpha=0.05)
    t16 = Trainer(Config(**kw, table_dtype="bfloat16"))
    h16 = t16.train()
    t32 = Trainer(Config(**kw))
    h32 = t32.train()
    assert t16.state.vec_w.dtype == jnp.bfloat16
    assert abs(h16["train_loss"][-1] - h32["train_loss"][-1]) < 5e-3

    ck = str(tmp_path / "bf16.ckpt")
    save_checkpoint(ck, t16.state)
    loaded, _ = load_checkpoint(ck)
    assert loaded.vec_w.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(loaded.vec_w), np.asarray(t16.state.vec_w))


def test_import_reference_model_exact_and_trainable(tmp_path, capsys):
    """Export -> --import_reference_model round trip: materialized weights
    and predictions match exactly (closed-form inversion at n=0), and
    training continues from the imported weights."""
    from ftrl_ffm_tpu.cli import main
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer
    from ftrl_ffm_tpu.io.checkpoint import export_reference_model

    data = str(tmp_path / "train.ffm")
    _write_ffm_file(data, n=64)
    cfg = Config(train_data=data, model_type="FFM", n_fields=N_FIELDS,
                 n_feats=N_FEATS, n_factors=K, batch_size=32, w_alpha=0.05)
    tr = Trainer(cfg)
    tr.train()
    bias, lin_w, vec_w = tr.model.materialize_weights(tr.state)
    blob = str(tmp_path / "ref.zst")
    export_reference_model(blob, float(bias), lin_w, vec_w)

    cfg2 = Config(model_type="FFM", n_fields=N_FIELDS, n_feats=N_FEATS,
                  n_factors=K, batch_size=32, max_nnz=tr.cfg.max_nnz)
    tr2 = Trainer(cfg2)
    from ftrl_ffm_tpu.io.checkpoint import import_reference_model
    b2, l2, v2 = import_reference_model(blob, N_FEATS, N_FIELDS * K)
    tr2.state = tr2.model.init_from_weights(b2, l2, v2)
    b3, l3, v3 = tr2.model.materialize_weights(tr2.state)
    np.testing.assert_allclose(float(b3), float(bias), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(l3), np.asarray(lin_w), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(v3), np.asarray(vec_w), rtol=1e-6, atol=1e-8)

    # CLI: warm-start then keep training
    rc = main([
        "--train_data", data, "--model_type", "FFM",
        "--n_fields", str(N_FIELDS), "--n_feats", str(N_FEATS),
        "--n_factors", str(K), "--batch_size", "32",
        "--import_reference_model", blob,
    ])
    assert rc == 0
    assert "imported reference model" in capsys.readouterr().out


def test_cli_auto_resume(tmp_path, capsys):
    """Elastic recovery: relaunching the same command with --auto_resume
    picks up from the checkpoint at --model_path."""
    from ftrl_ffm_tpu.cli import main

    data = str(tmp_path / "train.ffm")
    _write_ffm_file(data, n=64)
    ckpt = str(tmp_path / "model.ckpt")
    args = [
        "--train_data", data, "--model_type", "FFM",
        "--n_fields", str(N_FIELDS), "--n_feats", str(N_FEATS),
        "--n_factors", str(K), "--batch_size", "32",
        "--model_path", ckpt, "--auto_resume", "true",
    ]
    assert main(args) == 0
    out1 = capsys.readouterr().out
    assert "resumed" not in out1  # first run: nothing to resume
    st1, _ = load_checkpoint(ckpt)
    assert main(args) == 0
    out2 = capsys.readouterr().out
    assert "resumed from" in out2
    st2, _ = load_checkpoint(ckpt)
    assert int(st2.step) == 2 * int(st1.step)


# ------------------------------------------- compatibility validation (r4)
def test_resume_mismatched_config_raises(tmp_path):
    """A checkpoint resumed under different model-defining flags must fail
    with the named error, not an opaque XLA shape error."""
    from ftrl_ffm_tpu.cli import main
    from ftrl_ffm_tpu.io.checkpoint import IncompatibleStateError

    data = str(tmp_path / "train.ffm")
    _write_ffm_file(data)
    ckpt = str(tmp_path / "model.ckpt")
    assert main([
        "--train_data", data, "--model_type", "FFM",
        "--n_fields", str(N_FIELDS), "--n_feats", str(N_FEATS),
        "--n_factors", str(K), "--batch_size", "32", "--model_path", ckpt,
    ]) == 0

    for bad in (
        ["--n_factors", str(K + 1)],
        ["--n_feats", str(N_FEATS * 2)],
        ["--n_fields", str(N_FIELDS + 2)],
        ["--model_type", "FM"],
        ["--table_dtype", "bfloat16"],
    ):
        argv = [
            "--train_data", data, "--model_type", "FFM",
            "--n_fields", str(N_FIELDS), "--n_feats", str(N_FEATS),
            "--n_factors", str(K), "--batch_size", "32",
            "--load_model", ckpt,
        ]
        for flag, val in zip(bad[::2], bad[1::2]):
            if flag in argv:
                argv[argv.index(flag) + 1] = val
            else:
                argv += [flag, val]
        with pytest.raises(IncompatibleStateError, match="different model"):
            main(argv)


def test_trainer_state_shape_validation(tmp_path):
    """Trainer(cfg, state=...) structurally validates a caller-provided
    state (the Python-API twin of the CLI header check)."""
    from ftrl_ffm_tpu.io.checkpoint import IncompatibleStateError
    from ftrl_ffm_tpu.train import Trainer

    data = str(tmp_path / "train.ffm")
    _write_ffm_file(data)
    _, state = _trained_state("FFM")
    kw = dict(train_data=data, model_type="FFM", n_fields=N_FIELDS,
              n_factors=K, batch_size=32)
    # same config: accepted
    Trainer(Config(**kw, n_feats=N_FEATS), state=state)
    with pytest.raises(IncompatibleStateError, match="n_feats"):
        Trainer(Config(**kw, n_feats=N_FEATS + 7), state=state)
    with pytest.raises(IncompatibleStateError, match="factor"):
        Trainer(
            Config(**{**kw, "n_factors": K + 1}, n_feats=N_FEATS),
            state=state,
        )
    with pytest.raises(IncompatibleStateError, match="has factor tables"):
        Trainer(
            Config(train_data=data, model_type="LR", n_feats=N_FEATS,
                   batch_size=32),
            state=state,
        )
    with pytest.raises(IncompatibleStateError, match="table_dtype"):
        Trainer(
            Config(**kw, n_feats=N_FEATS, table_dtype="bfloat16"),
            state=state,
        )


def test_import_reference_model_size_mismatch_raises(tmp_path):
    """The unframed reference blob's only consistency check is the exact
    float count — a mismatched config must raise, not silently slice."""
    from ftrl_ffm_tpu.io.checkpoint import IncompatibleStateError

    model, state = _trained_state("FFM")
    bias, lin_w, vec_w = model.materialize_weights(state)
    path = str(tmp_path / "model.zst")
    export_reference_model(path, float(bias), lin_w, vec_w)
    # correct sizes load
    import_reference_model(path, N_FEATS, N_FIELDS * K)
    with pytest.raises(IncompatibleStateError, match="floats"):
        import_reference_model(path, N_FEATS, (N_FIELDS + 1) * K)
    with pytest.raises(IncompatibleStateError, match="floats"):
        import_reference_model(path, N_FEATS + 1, N_FIELDS * K)
    with pytest.raises(IncompatibleStateError, match="floats"):
        import_reference_model(path, N_FEATS, 0)  # LR read of an FFM blob


def test_import_reference_text_model_validation(tmp_path):
    from ftrl_ffm_tpu.io.checkpoint import IncompatibleStateError

    model, state = _trained_state("FFM")
    bias, lin_w, vec_w = model.materialize_weights(state)
    path = str(tmp_path / "model.txt")
    export_reference_text_model(path, float(bias), lin_w, vec_w)
    import_reference_text_model(path, N_FEATS, N_FIELDS * K)
    with pytest.raises(IncompatibleStateError, match="lines"):
        import_reference_text_model(path, N_FEATS + 3, N_FIELDS * K)
    with pytest.raises(IncompatibleStateError, match="factor rows"):
        import_reference_text_model(path, N_FEATS, N_FIELDS * K + 1)
    with pytest.raises(IncompatibleStateError, match="factor rows"):
        # WIDER import must also raise (a k=2K model under a k=K config) —
        # silently slicing the rows would scramble the warm start
        import_reference_text_model(path, N_FEATS, N_FIELDS * K - 1)
    bad = str(tmp_path / "bad.txt")
    with open(path) as f, open(bad, "w") as g:
        g.write(f.read().replace("0.", "x.", 1))
    with pytest.raises(IncompatibleStateError, match="malformed"):
        import_reference_text_model(bad, N_FEATS, N_FIELDS * K)


def test_cli_text_model_roundtrip(tmp_path, capsys):
    """--export_reference_text_model / --import_reference_text_model: the
    CLI twins of the FFM plain-text format (reference src/model/ffm.cpp:
    161-200).  Weights must survive the round trip."""
    from ftrl_ffm_tpu.cli import main
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    data = str(tmp_path / "train.ffm")
    _write_ffm_file(data, n=64)
    txt = str(tmp_path / "model.txt")
    ckpt = str(tmp_path / "trained.ckpt")
    assert main([
        "--train_data", data, "--model_type", "FFM",
        "--n_fields", str(N_FIELDS), "--n_feats", str(N_FEATS),
        "--n_factors", str(K), "--batch_size", "32",
        "--model_path", ckpt, "--export_reference_text_model", txt,
    ]) == 0
    assert "text-format model saved" in capsys.readouterr().out

    # import back: materialized weights equal the trained ones
    st, _ = load_checkpoint(ckpt)
    cfg = Config(model_type="FFM", n_fields=N_FIELDS, n_feats=N_FEATS,
                 n_factors=K, batch_size=32, max_nnz=N_FIELDS)
    tr = Trainer(cfg)
    b0, l0, v0 = tr.model.materialize_weights(st)
    b2, l2, v2 = import_reference_text_model(txt, N_FEATS, N_FIELDS * K)
    tr.state = tr.model.init_from_weights(b2, l2, v2)
    b3, l3, v3 = tr.model.materialize_weights(tr.state)
    np.testing.assert_allclose(float(b3), float(b0), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(l3), np.asarray(l0), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(v3), np.asarray(v0), rtol=1e-6,
                               atol=1e-8)

    # CLI import path trains on from the text model
    rc = main([
        "--train_data", data, "--model_type", "FFM",
        "--n_fields", str(N_FIELDS), "--n_feats", str(N_FEATS),
        "--n_factors", str(K), "--batch_size", "32",
        "--import_reference_text_model", txt,
    ])
    assert rc == 0
    assert "imported reference model" in capsys.readouterr().out

    # LR has no factor rows: text format refused with a clear error
    rc = main([
        "--train_data", data, "--model_type", "LR",
        "--n_feats", str(N_FEATS), "--batch_size", "32",
        "--export_reference_text_model", str(tmp_path / "lr.txt"),
    ])
    assert rc == 2
    # both import flags at once: ambiguous
    rc = main([
        "--train_data", data, "--model_type", "FFM",
        "--n_fields", str(N_FIELDS), "--n_feats", str(N_FEATS),
        "--n_factors", str(K),
        "--import_reference_model", txt,
        "--import_reference_text_model", txt,
    ])
    assert rc == 2


# ----------------------------------------- async mid-training saves (r5)
def test_async_mid_checkpoint_matches_sync(tmp_path):
    """--save_every under async_checkpoint=True (the default) writes the
    SAME state as the synchronous path — the device→host snapshot happens
    at the same step, only compression/write is overlapped — and
    train_epoch does not return before the write is durable (no .tmp
    leftovers, file loadable immediately)."""
    import os

    from ftrl_ffm_tpu.train import Trainer

    data = str(tmp_path / "t.ffm")
    _write_ffm_file(data, n=64, seed=3)
    cka, cks = str(tmp_path / "a.ckpt"), str(tmp_path / "s.ckpt")
    base = dict(
        train_data=data, model_type="FFM", n_fields=N_FIELDS,
        n_feats=N_FEATS, n_factors=K, batch_size=16, n_epochs=1,
        save_every=2, device_cache="off",
    )
    ta = Trainer(Config(**base, model_path=cka, async_checkpoint=True))
    ts = Trainer(Config(**base, model_path=cks, async_checkpoint=False))
    ta.train_epoch()
    ts.train_epoch()
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    sa, ea = load_checkpoint(cka)
    ss, es = load_checkpoint(cks)
    assert ea["mid_training_step"] == es["mid_training_step"] == 4
    for a, b in zip(sa, ss):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_write_is_crash_atomic(tmp_path):
    """A crash between snapshot and rename must leave the previous
    checkpoint intact: writes land in <path>.tmp.<pid> first (a simulated
    crash artifact there never affects loading), and a write that fails
    mid-stream neither truncates the existing checkpoint nor leaves the
    temp file behind."""
    import os

    model, state = _trained_state("FFM")
    path = str(tmp_path / "ckpt.zst")
    save_checkpoint(path, state, extra={"v": 1})
    good = open(path, "rb").read()

    # simulated crash artifact from a dead writer process
    open(path + ".tmp.99999", "wb").write(b"garbage not a checkpoint")
    loaded, extra = load_checkpoint(path)
    assert extra == {"v": 1}

    # a failing write must not clobber the previous checkpoint
    class Boom(Exception):
        pass

    class _Evil:
        dtype = np.dtype(np.float32)
        ndim = 1
        shape = (3,)

        def __iter__(self):
            raise Boom()

        def __getitem__(self, k):
            raise Boom()

    evil = state._replace(lin_w=_Evil())
    with pytest.raises(Boom):
        save_checkpoint(path, evil, extra={"v": 2})
    assert open(path, "rb").read() == good
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp.%d" % os.getpid())]
    loaded2, extra2 = load_checkpoint(path)
    assert extra2 == {"v": 1}


def test_async_checkpoint_failure_raises_at_join(tmp_path):
    """A background write failure must surface loudly at the next join
    (train_epoch end), not vanish with the thread."""
    from ftrl_ffm_tpu.train import Trainer

    data = str(tmp_path / "t.ffm")
    _write_ffm_file(data, n=64, seed=3)
    # model_path is a DIRECTORY -> open() in the writer thread fails
    cfg = Config(
        train_data=data, model_type="FFM", n_fields=N_FIELDS,
        n_feats=N_FEATS, n_factors=K, batch_size=16, n_epochs=1,
        save_every=2, model_path=str(tmp_path), device_cache="off",
    )
    tr = Trainer(cfg)
    with pytest.raises(RuntimeError, match="background checkpoint"):
        tr.train_epoch()
