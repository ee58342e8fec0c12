"""End-to-end training tests (the analogue of reference tests/test_task.cpp):
online + offline multi-epoch FFM training on the fixture must run, report
decreasing loss, and produce L1-sparsified (exactly zero) weights."""

import numpy as np
import pytest

from ftrl_ffm_tpu.config import Config
from ftrl_ffm_tpu.train import Trainer
from tests.common import FIXTURE_FEATS, FIXTURE_FIELDS, write_fixture


def _cfg(train_path, eval_path, online, **kw):
    base = dict(
        train_data=train_path,
        eval_data=eval_path,
        model_type="FFM",
        n_feats=FIXTURE_FEATS,
        n_fields=FIXTURE_FIELDS,
        n_factors=4,
        n_epochs=2,
        online=online,
        batch_size=16,
        # larger alpha so the fixture actually moves the loss in 2 epochs
        w_alpha=0.05,
        w_l1=0.15,
        w_l2=1.0,
    )
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("online", [True, False])
def test_end_to_end_ffm(tmp_path, online):
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    evalp = write_fixture(tmp_path / "eval.ffm", "libffm", seed=1)
    tr = Trainer(_cfg(train, evalp, online))
    hist = tr.train()
    assert len(hist["train_loss"]) == 2
    assert all(np.isfinite(hist["train_loss"]))
    assert hist["train_loss"][1] < hist["train_loss"][0]
    assert np.isfinite(hist["eval_loss"][-1])
    # L1 sparsification: some trained linear weights exactly zero
    _, lin_w, _ = tr.model.materialize_weights(tr.state)
    assert np.any(np.asarray(lin_w) == 0.0)


def test_lr_on_libsvm(tmp_path):
    train = write_fixture(tmp_path / "train.svm", "libsvm", seed=0)
    tr = Trainer(_cfg(train, "", True, model_type="LR", n_epochs=3))
    hist = tr.train()
    assert hist["train_loss"][-1] < hist["train_loss"][0]


def test_ffm_rejects_libsvm(tmp_path):
    train = write_fixture(tmp_path / "train.svm", "libsvm", seed=0)
    with pytest.raises(ValueError, match="libffm"):
        Trainer(_cfg(train, "", True, model_type="FFM"))


def test_online_offline_same_first_epoch_loss(tmp_path):
    """With shuffling off, online and offline visit the same batches."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    t_on = Trainer(_cfg(train, "", True, n_epochs=1))
    t_off = Trainer(_cfg(train, "", False, n_epochs=1, shuffle=False))
    h_on = t_on.train()
    h_off = t_off.train()
    assert h_on["train_loss"][0] == pytest.approx(h_off["train_loss"][0], rel=1e-5)


def test_eval_auc_reported(tmp_path):
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    evalp = write_fixture(tmp_path / "eval.ffm", "libffm", seed=1)
    tr = Trainer(_cfg(train, evalp, False, n_epochs=1))
    hist = tr.train()
    assert 0.0 <= hist["eval_auc"][-1] <= 1.0


def test_cmd_stdin_streaming(tmp_path, monkeypatch):
    """--cmd true streams training data from stdin (the reference only has a
    TODO stub for this branch, src/task/ftrl_online.cpp:55-57)."""
    import io

    rng = np.random.default_rng(0)
    lines = []
    for _ in range(40):
        toks = [str(int(rng.random() > 0.5))] + [
            f"{c}:{int(rng.integers(0, 50))}:1" for c in range(4)
        ]
        lines.append(" ".join(toks))
    fake_stdin = io.StringIO("\n".join(lines) + "\n")
    monkeypatch.setattr("sys.stdin", fake_stdin)

    cfg = Config(
        cmd=True, online=True, model_type="FFM", file_type="libffm",
        n_fields=4, n_feats=50, n_factors=2, batch_size=16, max_nnz=4,
        n_epochs=1,
    )
    tr = Trainer(cfg)
    loss = tr.train_epoch()
    assert np.isfinite(loss)
    assert int(tr.state.step) == 3  # ceil(40 / 16)


def test_save_every_mid_training_checkpoint(tmp_path):
    from ftrl_ffm_tpu.io.checkpoint import load_checkpoint

    path = str(tmp_path / "train.ffm")
    rng = np.random.default_rng(1)
    with open(path, "w") as f:
        for _ in range(64):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 50))}:1" for c in range(4)
            ]
            f.write(" ".join(toks) + "\n")
    ckpt = str(tmp_path / "mid.ckpt")
    cfg = Config(
        train_data=path, model_type="FFM", n_fields=4, n_feats=50,
        n_factors=2, batch_size=16, n_epochs=1, save_every=2, model_path=ckpt,
    )
    tr = Trainer(cfg)
    tr.train_epoch()
    state, extra = load_checkpoint(ckpt)
    assert extra["mid_training_step"] == 4  # 64/16 = 4 steps, saved at 2 and 4


@pytest.mark.parametrize("online", [True, False])
def test_steps_per_call_matches_single_step(tmp_path, online):
    """lax.scan multi-step dispatch == one-dispatch-per-step, including the
    inert-padded remainder group."""
    path = str(tmp_path / "t.ffm")
    rng = np.random.default_rng(2)
    with open(path, "w") as f:
        for _ in range(88):  # 6 batches of 16 -> groups of 4 need padding
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 50))}:1" for c in range(4)
            ]
            f.write(" ".join(toks) + "\n")
    kw = dict(
        train_data=path, eval_data=path, model_type="FFM", n_fields=4,
        n_feats=50, n_factors=2, batch_size=16, n_epochs=1, online=online,
        shuffle=False,
    )
    t1 = Trainer(Config(**kw, steps_per_call=1))
    h1 = t1.train()
    t4 = Trainer(Config(**kw, steps_per_call=4))
    h4 = t4.train()
    np.testing.assert_allclose(h1["train_loss"], h4["train_loss"], rtol=1e-6)
    np.testing.assert_allclose(h1["eval_loss"], h4["eval_loss"], rtol=1e-6)
    np.testing.assert_allclose(h1["eval_auc"], h4["eval_auc"], rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(t1.state.vec_z), np.asarray(t4.state.vec_z), rtol=1e-6
    )


def test_steps_per_call_sharded(tmp_path):
    path = str(tmp_path / "t.ffm")
    rng = np.random.default_rng(3)
    with open(path, "w") as f:
        for _ in range(96):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 50))}:1" for c in range(4)
            ]
            f.write(" ".join(toks) + "\n")
    kw = dict(
        train_data=path, eval_data=path, model_type="FFM", n_fields=4,
        n_feats=50, n_factors=2, batch_size=16, n_epochs=1, online=True,
    )
    t1 = Trainer(Config(**kw, steps_per_call=1))
    h1 = t1.train()
    tm = Trainer(Config(**kw, steps_per_call=4, mesh_data=4, mesh_model=2))
    hm = tm.train()
    np.testing.assert_allclose(h1["train_loss"], hm["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(h1["eval_loss"], hm["eval_loss"], rtol=1e-5)


def test_has_zero_weights_after_training(tmp_path):
    """Reference tests/test_task.cpp asserts has_zero_weights after training."""
    path = str(tmp_path / "t.ffm")
    rng = np.random.default_rng(5)
    with open(path, "w") as f:
        for _ in range(128):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 50))}:1" for c in range(4)
            ]
            f.write(" ".join(toks) + "\n")
    cfg = Config(
        train_data=path, model_type="FFM", n_fields=4, n_feats=50,
        n_factors=2, batch_size=16, n_epochs=2, w_alpha=0.05, w_l1=0.15,
    )
    tr = Trainer(cfg)
    tr.train()
    assert tr.model.has_zero_weights(tr.state)
    # generality parity with utils::has_zero_weights (utils.h:63-76): the
    # factor tables are checkable too.  L1=0.15 with these alphas also
    # sparsifies some factor coordinates within 2 epochs.
    assert tr.model.has_zero_weights(tr.state, table="factor")
    assert tr.model.has_zero_weights(tr.state, table="any")
    with pytest.raises(ValueError):
        tr.model.has_zero_weights(tr.state, table="bogus")


def test_has_zero_weights_factor_excludes_mirror_lane():
    """The FFM dead-lane linear mirror lives inside vec_w: a zero LINEAR
    weight there must not be reported as FACTOR sparsification
    (code-review fix)."""
    import jax.numpy as jnp
    from ftrl_ffm_tpu.models import make_model

    # n_fields=7, n_factors=16 -> field_pad=8 (one dead lane per k)
    cfg = Config(model_type="FFM", n_feats=8, n_fields=7, n_factors=16,
                 batch_size=8, max_nnz=4)
    assert cfg.field_pad == 8
    model = make_model(cfg)
    st = model.init()
    cp, c = cfg.field_pad, cfg.n_fields
    lane_field = np.arange(cfg.row_width) % cp
    genuine = lane_field < c
    # all genuine factor coords touched and nonzero; mirror lane touched
    # with weight 0 (a linear zero)
    vec_n = np.where(genuine, 1.0, 0.0).astype(np.float32)
    vec_n[cfg.n_fields] = 1.0  # lane (0, n_fields): the linear mirror
    vec_n = np.broadcast_to(vec_n, (cfg.n_feats, cfg.row_width)).copy()
    vec_w = np.where(genuine, 0.5, 0.0).astype(np.float32)
    vec_w = np.broadcast_to(vec_w, (cfg.n_feats, cfg.row_width)).copy()
    st = st._replace(vec_n=jnp.asarray(vec_n), vec_w=jnp.asarray(vec_w))
    assert model.has_zero_weights(st, table="factor") is False
    # a genuine zeroed factor coordinate IS reported
    vec_w[0, 0] = 0.0
    st = st._replace(vec_w=jnp.asarray(vec_w))
    assert model.has_zero_weights(st, table="factor") is True


def test_has_zero_weights_factor_lr_is_false(tmp_path):
    """LR has no factor tables: the factor check is False, not an error."""
    path = str(tmp_path / "t.svm")
    with open(path, "w") as f:
        for i in range(32):
            f.write(f"{i % 2} {i % 7}:1 {7 + i % 5}:1\n")
    cfg = Config(train_data=path, model_type="LR", n_feats=16, batch_size=16,
                 n_epochs=1)
    tr = Trainer(cfg)
    tr.train()
    assert tr.model.has_zero_weights(tr.state, table="factor") is False


def test_profile_dir_writes_trace(tmp_path):
    import os

    path = str(tmp_path / "t.ffm")
    rng = np.random.default_rng(6)
    with open(path, "w") as f:
        for _ in range(32):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 50))}:1" for c in range(4)
            ]
            f.write(" ".join(toks) + "\n")
    prof = str(tmp_path / "trace")
    cfg = Config(train_data=path, model_type="LR", n_feats=50, n_fields=4,
                 batch_size=16, n_epochs=1)
    Trainer(cfg).train(profile_dir=prof)
    found = []
    for root, _, files in os.walk(prof):
        found.extend(files)
    assert found, "jax.profiler trace produced no files"

def test_eval_only_trainer_sniffs_from_eval_data(tmp_path):
    """A Trainer built without train_data must sniff
    file_type/max_nnz from eval_data instead of scoring zero-width batches."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    evalp = write_fixture(tmp_path / "eval.ffm", "libffm", seed=1)
    tr = Trainer(_cfg(train, evalp, True))
    tr.train()

    eval_only = Trainer(_cfg("", evalp, True), state=tr.state)
    assert eval_only.cfg.max_nnz == tr.cfg.max_nnz
    loss, auc = eval_only.evaluate()
    assert np.isfinite(loss)
    # and with no data at all it must raise, not degenerate
    with pytest.raises(ValueError, match="max_nnz"):
        Trainer(_cfg("", "", True))


def test_cli_update_mode_sparse(tmp_path, capsys):
    from ftrl_ffm_tpu.cli import main

    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    rc = main([
        "--train_data", str(train), "--model_type", "FFM",
        "--n_fields", str(FIXTURE_FIELDS), "--n_feats", str(FIXTURE_FEATS),
        "--n_factors", "4", "--batch_size", "16",
        "--update_mode", "sparse", "--use_pallas", "off",
        "--table_dtype", "float32", "--compact_transfer", "false",
        "--steps_per_call", "2",
    ])
    assert rc == 0
    assert "epoch 1 train time" in capsys.readouterr().out


def test_compact_transfer_lossless_only(tmp_path):
    """ADVICE: compacting must not quantize real-valued features or
    fractional sample weights — those batches ride as f32."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(_cfg(train, "", True, compact_transfer=True))
    fields = np.zeros((4, 2), np.int32)
    feats = np.zeros((4, 2), np.int32)
    y = np.zeros(4, np.float32)
    ones = np.ones(4, np.float32)
    # exactly all-1.0 with no padding -> the zero-width ones marker
    vals = np.full((4, 2), 1.0, np.float32)
    out = tr._compact((fields, feats, vals, y, ones))
    assert out[2].shape == (4, 0) and out[4].dtype == np.int8
    # integral but not all-ones -> int8
    vals = np.full((4, 2), 2.0, np.float32)
    out = tr._compact((fields, feats, vals, y, ones))
    assert out[2].dtype == np.int8
    # all-1.0 but padded (sentinel id present) -> dtype path, not the marker
    feats_pad = feats.copy()
    feats_pad[-1] = tr.cfg.n_feats
    vals = np.full((4, 2), 1.0, np.float32)
    out = tr._compact((fields, feats_pad, vals, y, ones))
    assert out[2].shape == (4, 2) and out[2].dtype == np.int8
    # non-representable values / fractional weights -> kept f32
    # (1/3 is not int8/bf16-exact and not 6-decimal fixed-point, so no
    # narrowing tier — including DEC6 — may touch it)
    vals = np.full((4, 2), np.float32(1) / np.float32(3), np.float32)
    half = np.full(4, 0.5, np.float32)
    out = tr._compact((fields, feats, vals, y, half))
    assert out[2].dtype == np.float32 and out[4].dtype == np.float32


def test_compact_roundtrip_loss_identical(tmp_path):
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    h1 = Trainer(_cfg(train, "", True, compact_transfer=True)).train()
    h2 = Trainer(_cfg(train, "", True, compact_transfer=False)).train()
    assert h1["train_loss"] == h2["train_loss"]


def test_layout_pinned_state_matches_unpinned(tmp_path, monkeypatch):
    """Row-major table-layout pinning (models/base.py::state_formats) is a
    pure performance choice: losses are identical with pinning disabled."""
    import ftrl_ffm_tpu.models.base as base_mod
    from ftrl_ffm_tpu.models.base import state_formats

    rng = np.random.default_rng(0)
    path = tmp_path / "t.ffm"
    with open(path, "w") as f:
        for _ in range(96):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 200))}:1" for c in range(16)
            ]
            f.write(" ".join(toks) + "\n")
    kw = dict(
        train_data=str(path), model_type="FFM", n_fields=16, n_feats=200,
        n_factors=8, batch_size=32, n_epochs=2, online=True, eval_auc=False,
    )
    t1 = Trainer(Config(**kw))
    assert t1._fmt is not None  # E = 16 * 8 = 128: pinning active
    h1 = t1.train()

    monkeypatch.setattr(base_mod, "state_formats", lambda *a, **k: None)
    import ftrl_ffm_tpu.train as train_mod
    t2 = Trainer(Config(**kw))
    assert t2._fmt is None
    h2 = t2.train()
    np.testing.assert_allclose(h1["train_loss"], h2["train_loss"], rtol=1e-6)

    # narrow rows (FM E=k) stay un-pinned: lane padding would blow up tables
    from ftrl_ffm_tpu.models import make_model
    fm = make_model(Config(model_type="FM", n_feats=50, n_factors=8))
    assert state_formats(fm.init()) is None


# ------------------------------------------------------------- predict_file
def test_predict_file_and_stdin(tmp_path, monkeypatch, capsys):
    """predict_file: one in-(0,1) probability per input line, padded tail
    dropped; '-' input scores a stdin stream and '-' output writes stdout,
    both identical to the file path (pipe-based batch serving)."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    score = write_fixture(tmp_path / "score.ffm", "libffm", seed=2)
    # 64 fixture lines with batch 24: last batch is padded (64 = 2*24 + 16)
    tr = Trainer(_cfg(train, "", True, batch_size=24, n_epochs=1))
    tr.train()

    out = tmp_path / "preds.txt"
    n = tr.predict_file(score, str(out))
    lines = out.read_text().splitlines()
    assert n == len(lines) == sum(1 for _ in open(score))
    probs = np.array([float(x) for x in lines])
    assert np.all((probs > 0) & (probs < 1))

    # stdin -> stdout must produce the same scores
    capsys.readouterr()  # clear buffered training prints
    monkeypatch.setattr("sys.stdin", open(score))
    n2 = tr.predict_file("-", "-")
    captured = capsys.readouterr().out.splitlines()
    assert n2 == n
    np.testing.assert_allclose(
        [float(x) for x in captured], probs, rtol=0, atol=0
    )


def test_predict_stdin_requires_file_type(tmp_path):
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(_cfg(train, "", True, n_epochs=1))
    tr.cfg.file_type = ""
    with pytest.raises(ValueError, match="file_type"):
        tr.predict_file("-", "-")


def test_cli_predict_stdin_flag_validation(tmp_path, capsys):
    from ftrl_ffm_tpu.cli import main

    rc = main(["--predict_data", "-", "--load_model", "nonexistent.ckpt"])
    assert rc == 2
    assert "--file_type and --max_nnz" in capsys.readouterr().err


# ------------------------------------------- in-place update + stale lin sync
def _mirror_cfg(train_path, **kw):
    """FFM config where field_pad adopts a dead lane (C=7, K=16 -> C'=8),
    so the linear mirror is active."""
    base = dict(
        train_data=train_path,
        model_type="FFM",
        n_feats=60,
        n_fields=7,
        n_factors=16,
        n_epochs=2,
        online=True,
        batch_size=16,
        w_alpha=0.05,
        w_l1=0.15,
        w_l2=1.0,
    )
    base.update(kw)
    return Config(**base)


def _write_7field_ffm(path, n=64, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, 60))}:1" for c in range(7)
            ]
            f.write(" ".join(toks) + "\n")
    return str(path)


def test_inplace_skips_lin_update_and_syncs_from_mirror(tmp_path):
    """update_mode=inplace with the dead-lane mirror: the separate linear
    scatter is skipped (lin arrays ride stale), and the boundary sync from
    the mirror reproduces the dense path's linear tables."""
    train = _write_7field_ffm(tmp_path / "train.ffm")
    t_in = Trainer(_mirror_cfg(train, update_mode="inplace"))
    assert t_in.model._lin_mirror_maintained()
    assert t_in._lin_rides_stale()
    h_in = t_in.train()

    t_dn = Trainer(_mirror_cfg(train, update_mode="dense"))
    assert not t_dn._lin_rides_stale()
    h_dn = t_dn.train()

    # identical training trajectory (losses use logits, not lin arrays)
    np.testing.assert_allclose(h_in["train_loss"], h_dn["train_loss"], rtol=1e-6)

    # raw state: lin arrays are stale (never touched) on the inplace run
    np.testing.assert_array_equal(np.asarray(t_in.state.lin_z), 0.0)
    assert np.any(np.asarray(t_dn.state.lin_z) != 0.0)

    # boundary sync (logical_state) reconciles from the mirror == dense lin
    s_in = t_in.logical_state
    s_dn = t_dn.logical_state
    np.testing.assert_allclose(
        np.asarray(s_in.lin_z), np.asarray(s_dn.lin_z), rtol=1e-5, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(s_in.lin_n), np.asarray(s_dn.lin_n), rtol=1e-5, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(s_in.lin_w), np.asarray(s_dn.lin_w), rtol=1e-5, atol=1e-8
    )


def test_inplace_checkpoint_resume_after_sync(tmp_path):
    """Checkpoints taken during an inplace run carry reconciled linear
    tables; resuming from one continues identically to the dense path."""
    train = _write_7field_ffm(tmp_path / "train.ffm")
    ckpt = str(tmp_path / "m.ckpt")

    t_in = Trainer(_mirror_cfg(train, update_mode="inplace", n_epochs=1))
    t_in.train()
    t_in.save_checkpoint(ckpt)

    from ftrl_ffm_tpu.io.checkpoint import load_checkpoint

    state, _ = load_checkpoint(ckpt)
    t_dn = Trainer(_mirror_cfg(train, update_mode="dense", n_epochs=1))
    t_dn.train()
    np.testing.assert_allclose(
        np.asarray(state.lin_z),
        np.asarray(t_dn.state.lin_z),
        rtol=1e-5, atol=1e-8,
    )
    # resume: one more epoch from the checkpoint matches dense continuing
    t_res = Trainer(_mirror_cfg(train, update_mode="inplace", n_epochs=1),
                    state=state)
    h_res = t_res.train()
    h_dn2 = t_dn.train()
    np.testing.assert_allclose(
        h_res["train_loss"], h_dn2["train_loss"], rtol=1e-6
    )


def test_mirror_off_keeps_exact_lin(tmp_path):
    """Without a dead lane (field_pad == n_fields) the inplace path keeps
    the canonical linear update — nothing rides stale."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    t = Trainer(_cfg(train, "", True, update_mode="inplace"))
    assert not t._lin_rides_stale()
    h = t.train()
    assert np.any(np.asarray(t.state.lin_z) != 0.0)
    assert all(np.isfinite(h["train_loss"]))


def test_cli_predict_stdout_stream_is_clean(tmp_path, capsys):
    """With --predict_output -, stdout carries ONLY probabilities (one per
    line); every informational print is rerouted to stderr."""
    from ftrl_ffm_tpu.cli import main

    data = _write_7field_ffm(tmp_path / "train.ffm")
    rc = main([
        "--train_data", data, "--eval_data", data,
        "--model_type", "FFM", "--n_fields", "7", "--n_feats", "60",
        "--n_factors", "4", "--n_epochs", "1", "--batch_size", "16",
        "--predict_data", data, "--predict_output", "-",
    ])
    assert rc in (0, None)
    cap = capsys.readouterr()
    lines = cap.out.splitlines()
    assert len(lines) == 64
    for ln in lines:
        assert 0.0 < float(ln) < 1.0
    assert "epoch 1 train time" in cap.err  # trainer logs went to stderr
    assert "wrote 64 predictions" in cap.err


def test_cli_rejects_cmd_with_stdin_predict(capsys):
    from ftrl_ffm_tpu.cli import main

    rc = main(["--cmd", "true", "--file_type", "libffm", "--max_nnz", "4",
               "--predict_data", "-"])
    assert rc == 2
    assert "both read stdin" in capsys.readouterr().err


def test_hbm_estimator_route_terms():
    """estimate_hbm_bytes must model route mode's bucket buffers: the
    send/recv pairs for lookup ([M*K, w] x2) and update ([M*K, 2w] x2) are
    sized by route_capacity and can OOM before the tables do (ADVICE r3).
    Pure-function unit test of the estimator's terms."""
    from ftrl_ffm_tpu.parallel.sharded import route_slots
    from ftrl_ffm_tpu.train import estimate_hbm_bytes

    kw = dict(
        model_type="FFM", n_feats=1_000_000, n_fields=39, n_factors=16,
        max_nnz=39, batch_size=8192, mesh_model=8,
    )
    rep = estimate_hbm_bytes(Config(**kw, lookup_mode="replicate"))
    assert rep["route"] == 0
    w = Config(**kw).row_width
    r_loc = -(-1_000_000 // 8)
    # state: factor n/z f32 + w f32 + three linear tables
    assert rep["state"] == r_loc * w * 12 + 3 * r_loc * 4

    cfg_route = Config(**kw, lookup_mode="route")
    est = estimate_hbm_bytes(cfg_route)
    mk = 8 * route_slots(cfg_route, 8, 1)
    assert est["route"] == 6 * w * mk * 4
    assert est["total"] == est["state"] + est["work"] + est["route"]
    # capacity scales the bucket term (the exact failure mode ADVICE named:
    # oversized route configs OOM in the buckets with no warning)
    est4 = estimate_hbm_bytes(Config(**kw, lookup_mode="route",
                                     route_capacity=4.0))
    assert est4["route"] > 1.9 * est["route"]
    # auto resolves to route when shapes divide -> same bucket term
    est_auto = estimate_hbm_bytes(Config(**kw, lookup_mode="auto"))
    assert est_auto["route"] == est["route"]


def test_hbm_estimator_single_device_regimes():
    """Unsharded estimator terms: dense2's [R, 2D] accumulator for small
    tables, the single [R, D] in-place accumulator for huge ones."""
    from ftrl_ffm_tpu.train import estimate_hbm_bytes

    kw = dict(model_type="FFM", n_fields=39, n_factors=16, max_nnz=39,
              batch_size=8192)
    small = Config(**kw, n_feats=100_000)
    big = Config(**kw, n_feats=1_200_000)
    w = small.row_width
    est_s = estimate_hbm_bytes(small)
    est_b = estimate_hbm_bytes(big)
    nnz = 8192 * 39
    assert est_s["work"] == 2 * 100_000 * w * 4 + 3 * nnz * w * 4
    assert est_b["work"] == 1_200_000 * w * 4 + 3 * nnz * w * 4
    assert est_s["route"] == est_b["route"] == 0


def test_fields_iota_marker_roundtrip(tmp_path):
    """Canonical one-feature-per-field data ships fields as the zero-row
    iota marker ([0, F] — ~25% of the canonical upload bytes) and must
    train identically to compact_transfer=False."""
    import jax.numpy as jnp

    from ftrl_ffm_tpu.models.base import Batch, widen_batch

    rng = np.random.default_rng(3)
    path = str(tmp_path / "canon.ffm")
    with open(path, "w") as f:
        for _ in range(64):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, FIXTURE_FEATS))}:1"
                for c in range(FIXTURE_FIELDS)
            ]
            f.write(" ".join(toks) + "\n")

    kw = dict(train_data=path, model_type="FFM", n_feats=FIXTURE_FEATS,
              n_fields=FIXTURE_FIELDS, n_factors=4, n_epochs=2,
              batch_size=16, w_alpha=0.05)
    t_on = Trainer(Config(**kw))
    h_on = t_on.train()
    t_off = Trainer(Config(**kw, compact_transfer=False))
    h_off = t_off.train()
    np.testing.assert_allclose(h_on["train_loss"], h_off["train_loss"],
                               rtol=1e-6)

    # the marker actually engages on a full canonical batch
    arrays = next(iter(t_on._train_batches(np.random.default_rng(0))))
    c = Trainer(Config(**kw))._compact(arrays)
    assert c[0].shape[-2] == 0 and c[0].shape[-1] == FIXTURE_FIELDS
    assert c[0].dtype == np.int8

    # widen_batch reconstructs the iota exactly
    b = Batch(
        fields=jnp.zeros((0, 4), jnp.int8),
        feats=jnp.asarray(rng.integers(0, 10, (8, 4)), jnp.int32),
        vals=jnp.ones((8, 4), jnp.float32),
        y=jnp.zeros((8,), jnp.int8),
        sample_w=jnp.ones((8,), jnp.int8),
    )
    w = widen_batch(b)
    np.testing.assert_array_equal(
        np.asarray(w.fields), np.broadcast_to(np.arange(4), (8, 4))
    )
    # and the LR zero-WIDTH fields marker is untouched by the iota decode
    b_lr = b._replace(fields=jnp.zeros((8, 0), jnp.int8))
    assert widen_batch(b_lr).fields.shape == (8, 0)


def test_fields_iota_marker_sharded(tmp_path):
    """The [0, F] fields marker must survive mesh placement (0 rows shard
    evenly) on both replicate and route meshes, with losses equal to the
    single-device run."""
    rng = np.random.default_rng(5)
    path = str(tmp_path / "canon.ffm")
    with open(path, "w") as f:
        for _ in range(128):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(0, FIXTURE_FEATS))}:1"
                for c in range(FIXTURE_FIELDS)
            ]
            f.write(" ".join(toks) + "\n")
    kw = dict(train_data=path, model_type="FFM", n_feats=FIXTURE_FEATS,
              n_fields=FIXTURE_FIELDS, n_factors=4, n_epochs=1,
              batch_size=32, w_alpha=0.05)
    ref = Trainer(Config(**kw)).train()
    for mesh in ((4, 2), (1, 8)):
        hist = Trainer(
            Config(**kw, mesh_data=mesh[0], mesh_model=mesh[1])
        ).train()
        np.testing.assert_allclose(
            hist["train_loss"], ref["train_loss"], rtol=2e-5,
            err_msg=f"mesh {mesh}",
        )


# ---- interleaved feeder (feed_workers > 1) ----


def test_feed_interleaved_preserves_order_and_results(tmp_path):
    """feed_workers=2 must produce the bit-identical training run: the
    reorder buffer preserves stream order, so FTRL update order — and
    therefore every loss and weight — is unchanged."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    evalp = write_fixture(tmp_path / "eval.ffm", "libffm", seed=1)
    runs = []
    for workers in (1, 2):
        tr = Trainer(_cfg(train, evalp, True, n_epochs=2,
                          device_cache="off", feed_workers=workers))
        hist = tr.train()
        _, lin_w, vec_w = tr.model.materialize_weights(tr.state)
        runs.append((hist["train_loss"], np.asarray(lin_w),
                     None if vec_w is None else np.asarray(vec_w)))
    (l1, w1, v1), (l2, w2, v2) = runs
    assert l1 == l2
    np.testing.assert_array_equal(w1, w2)
    if v1 is not None:
        np.testing.assert_array_equal(v1, v2)


def test_feed_interleaved_ordering_stress():
    """Drive _feed_interleaved directly with a jittery place() over many
    items: output must be exactly the input order, each item placed once."""
    import random
    import time as _time

    from ftrl_ffm_tpu.train import Trainer as _T

    class Dummy:
        _proc_n = 1

        class cfg:
            feed_workers = 3

    rng = random.Random(0)

    def place(i):
        _time.sleep(rng.random() * 0.002)
        return i * 10

    out = list(_T._feed_interleaved(Dummy(), iter(range(200)), place, 3))
    assert out == [i * 10 for i in range(200)]


def test_feed_interleaved_propagates_errors():
    from ftrl_ffm_tpu.train import Trainer as _T

    class Dummy:
        _proc_n = 1

    def place(i):
        if i == 5:
            raise RuntimeError("boom in place")
        return i

    with pytest.raises(RuntimeError, match="boom in place"):
        list(_T._feed_interleaved(Dummy(), iter(range(50)), place, 2))


# ---- SPLIT feats transfer tier (delta-refusing ids) ----


def _widen_np(fields, feats, vals, y, sw, base):
    from ftrl_ffm_tpu.models.base import Batch, widen_batch
    import jax.numpy as jnp

    b = Batch(*(None if a is None else jnp.asarray(a)
                for a in (fields, feats, vals, y, sw, base)))
    return np.asarray(widen_batch(b).feats)


@pytest.mark.parametrize(
    "n_feats", [60_000, 100_000, 131_071, 10_000_000, 16_777_215]
)
def test_split_feats_roundtrip(tmp_path, n_feats):
    """lo-u16 + hi-bitplane encode/decode is exact for ids <= n_feats
    (sentinel included) across the k = 0..8 tier widths."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(_cfg(train, "", True, n_feats=n_feats))
    rng = np.random.default_rng(1)
    feats = rng.integers(0, n_feats + 1, (32, 13)).astype(np.int32)
    feats[-1, -5:] = n_feats  # padding sentinel rides the same encoding
    lo, hi = tr._split_feats(feats)
    assert lo.dtype == np.uint16
    k = max(0, int(n_feats).bit_length() - 16)
    assert hi.shape == (32, k, (13 + 7) // 8) and hi.dtype == np.uint8
    got = _widen_np(np.zeros((32, 13), np.int8), lo,
                    np.ones((32, 13), np.float32),
                    np.zeros(32, np.float32), np.ones(32, np.float32), hi)
    np.testing.assert_array_equal(got, feats)


def test_split_feats_scan_group_3d(tmp_path):
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(_cfg(train, "", True, n_feats=100_000))
    rng = np.random.default_rng(2)
    feats = rng.integers(0, 100_001, (3, 8, 11)).astype(np.int32)
    lo, hi = tr._split_feats(feats)
    assert lo.shape == (3, 8, 11) and hi.shape == (3, 1, 2)[:1] + hi.shape[1:]
    assert hi.shape == (3, 8, 1, 2)[0:1] + hi.shape[1:]  # leading S kept
    got = _widen_np(np.zeros((3, 8, 11), np.int8), lo,
                    np.ones((3, 8, 11), np.float32),
                    np.zeros((3, 8), np.float32),
                    np.ones((3, 8), np.float32), hi)
    np.testing.assert_array_equal(got, feats)


def test_compact_split_tier_engages_when_delta_fails(tmp_path):
    """Ids spread past uint16 within a column (shuffled token order) refuse
    the delta encoding; the split tier must take over instead of int32."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(_cfg(train, "", True, n_feats=100_000))
    fields = np.tile(np.arange(2, dtype=np.int32), (6, 1))
    feats = np.array([[0, 99_000]] * 5 + [[70_000, 3]], np.int32)
    vals = np.full((6, 2), 0.123456, np.float32)
    y = np.zeros(6, np.float32)
    sw = np.ones(6, np.float32)
    out = tr._compact((fields, feats, vals, y, sw))
    assert out[1].dtype == np.uint16
    assert out[5] is not None and out[5].dtype == np.uint8
    assert out[5].shape == (6, 1, 1)
    got = _widen_np(out[0], out[1], vals, y, sw, out[5])
    np.testing.assert_array_equal(got, feats)
    # and training numerics are unchanged by the tier (compact on == off)
    rng = np.random.default_rng(3)
    path = tmp_path / "spread.ffm"
    with open(path, "w") as f:
        for i in range(64):
            toks = [str(rng.integers(0, 2))] + [
                f"{c}:{rng.integers(0, 100_000)}:1" for c in range(3)
            ]
            f.write(" ".join(toks) + "\n")
    kw = dict(n_feats=100_000, n_fields=3, batch_size=16)
    h1 = Trainer(_cfg(str(path), "", True, compact_transfer=True, **kw)).train()
    h2 = Trainer(_cfg(str(path), "", True, compact_transfer=False, **kw)).train()
    assert h1["train_loss"] == h2["train_loss"]


def test_split_tier_out_of_scope_keeps_int32(tmp_path):
    """n_feats >= 2^24 exceeds the 8 packable hi bits: ids ride int32."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(_cfg(train, "", True, n_feats=16_777_216))
    feats = np.array([[0, 16_000_000], [16_000_000, 0]] * 2, np.int32)
    out = tr._compact((np.zeros((4, 2), np.int32), feats,
                       np.full((4, 2), 0.5, np.float32),
                       np.zeros(4, np.float32), np.ones(4, np.float32)))
    assert out[1].dtype == np.int32 and out[5] is None


def test_exact_auc_conflicts_fail_at_init(tmp_path):
    """Statically-knowable auc_mode=exact conflicts raise at Trainer
    construction, not after a full training epoch at the first eval."""
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    with pytest.raises(ValueError, match="shard"):
        Trainer(_cfg(train, "", True, auc_mode="exact",
                     device_cache_layout="shard"))


def test_feed_workers_pinned_for_cmd_stdin(tmp_path):
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(_cfg(train, "", True, feed_workers=4))
    assert tr._feed_worker_count() == 4  # honored, no hidden clamp
    tr.cfg.cmd = True
    assert tr._feed_worker_count() == 1  # stdin pins 1


# ---- DEC6 vals transfer tier (6-decimal fixed-point reals) ----


def test_dec6_vals_roundtrip(tmp_path):
    """%.6f-parsed reals (the reference's own generate_data.py output
    format) ship as 3 bytes/value and reconstruct bit-exactly."""
    from ftrl_ffm_tpu.models.base import Batch, widen_batch
    import jax.numpy as jnp

    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(_cfg(train, "", True))
    rng = np.random.default_rng(7)
    k = rng.integers(0, 1_000_000, (32, 5))
    vals = (k.astype(np.float32) / np.float32(1e6)).astype(np.float32)
    vals[0, 0] = 0.0           # padding slots carry 0.0
    vals[1, 1] = np.float32((1 << 24) - 1) / np.float32(1e6)  # max tier value
    enc = tr._dec6_vals(vals)
    assert enc is not None and enc.dtype == np.uint8
    assert enc.shape == (32, 15)
    b = Batch(jnp.zeros((32, 5), jnp.int8), jnp.zeros((32, 5), jnp.int32),
              jnp.asarray(enc), jnp.zeros(32), jnp.ones(32))
    got = np.asarray(widen_batch(b).vals)
    np.testing.assert_array_equal(got, vals)


def test_dec6_vals_rejects_and_disables(tmp_path):
    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(_cfg(train, "", True))
    good = np.full((4, 2), np.float32(123456) / np.float32(1e6), np.float32)
    assert tr._dec6_vals(good) is not None
    # a genuinely non-decimal f32 disables the tier for the run
    bad = np.full((4, 2), np.float32(1/3), np.float32)
    assert tr._dec6_vals(bad) is None
    assert tr._dec6_ok is False
    assert tr._dec6_vals(good) is None  # hysteresis: stays off
    # negatives reject too
    tr2 = Trainer(_cfg(train, "", True))
    assert tr2._dec6_vals(np.full((2, 2), -0.5, np.float32)) is None


def test_dec6_engages_in_compact_and_trains_identically(tmp_path):
    """End-to-end: decimal-valued libffm data rides the DEC6 tier with
    training numerics identical to compact_transfer=False."""
    rng = np.random.default_rng(9)
    path = tmp_path / "dec.ffm"
    with open(path, "w") as f:
        for i in range(64):
            toks = [str(rng.integers(0, 2))] + [
                f"{c}:{rng.integers(0, 50)}:{rng.integers(1, 10**6) / 10**6:.6f}"
                for c in range(3)
            ]
            f.write(" ".join(toks) + "\n")
    kw = dict(n_feats=50, n_fields=3, batch_size=16)
    tr = Trainer(_cfg(str(path), "", True, compact_transfer=True, **kw))
    arrays = next(iter(tr._train_batches(np.random.default_rng(0))))
    out = tr._compact(arrays)
    assert out[2].dtype == np.uint8 and out[2].shape[-1] == arrays[2].shape[-1] * 3
    h1 = Trainer(_cfg(str(path), "", True, compact_transfer=True, **kw)).train()
    h2 = Trainer(_cfg(str(path), "", True, compact_transfer=False, **kw)).train()
    assert h1["train_loss"] == h2["train_loss"]


# ---- bit-packed fields transfer tier ----


def test_packed_fields_roundtrip_and_training(tmp_path):
    """Non-iota fields (shuffled token order) ride w-bit bitplanes
    (6 bits at 39 fields); decode is exact and training matches
    compact_transfer=False."""
    from ftrl_ffm_tpu.models.base import Batch, widen_batch
    import jax.numpy as jnp

    train = write_fixture(tmp_path / "train.ffm", "libffm", seed=0)
    tr = Trainer(_cfg(train, "", True, n_fields=39, n_feats=1000))
    rng = np.random.default_rng(11)
    fields = rng.integers(0, 39, (16, 13)).astype(np.int32)
    packed = tr._pack_fields(fields)
    assert packed is not None
    assert packed.shape == (16, 6, 2) and packed.dtype == np.uint8
    b = Batch(jnp.asarray(packed), jnp.zeros((16, 13), jnp.int32),
              jnp.ones((16, 13), jnp.float32), jnp.zeros(16), jnp.ones(16))
    got = np.asarray(widen_batch(b).fields)
    np.testing.assert_array_equal(got, fields)
    # not engaged when it wouldn't shrink the upload (tiny F)
    assert tr._pack_fields(fields[:, :4]) is None

    # end-to-end on shuffled-field-order libffm data
    rng = np.random.default_rng(12)
    path = tmp_path / "shuf.ffm"
    with open(path, "w") as f:
        for i in range(48):
            cs = rng.permutation(9)[:5]
            toks = [str(rng.integers(0, 2))] + [
                f"{c}:{rng.integers(0, 80)}:1" for c in cs
            ]
            f.write(" ".join(toks) + "\n")
    kw = dict(n_feats=80, n_fields=9, batch_size=16, max_nnz=5)
    tr1 = Trainer(_cfg(str(path), "", True, compact_transfer=True, **kw))
    arrays = next(iter(tr1._train_batches(np.random.default_rng(0))))
    c = tr1._compact(arrays)
    assert c[0].dtype == np.uint8 and c[0].ndim == 3  # packed tier engaged
    h1 = tr1.train()
    h2 = Trainer(_cfg(str(path), "", True, compact_transfer=False, **kw)).train()
    assert h1["train_loss"] == h2["train_loss"]
