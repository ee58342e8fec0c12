"""Multi-host (multi-process) data sharding and SPMD execution.

Two tiers (SURVEY §4's "new" multi-host test tier):
  * process_byte_range / ranged readers partition the file exactly;
  * a REAL 2-process jax.distributed CPU run (subprocess workers, TCP
    coordinator) trains end-to-end and must match the single-process loss —
    the `--coordinator_address` path executed for real, not just parsed.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from ftrl_ffm_tpu.data.loader import count_lines, load_file, process_byte_range
from ftrl_ffm_tpu.data.stream import StreamReader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_fixed_width_ffm(path, n=256, n_fields=4, n_feats=50, seed=0):
    """Equal-byte-length lines so 2 byte-range shards hold exactly n/2 lines
    each (keeps the 2-process global batch == the single-process batch)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            toks = [str(int(rng.random() > 0.5))] + [
                f"{c}:{int(rng.integers(10, n_feats)):02d}:1"
                for c in range(n_fields)
            ]
            f.write(" ".join(toks) + "\n")
    return str(path)


def test_process_byte_range_partitions_exactly(tmp_path):
    path = _write_fixed_width_ffm(tmp_path / "d.ffm", n=257)  # odd on purpose
    all_lines = open(path).readlines()
    got = []
    total = 0
    for p in range(3):
        rng = process_byte_range(path, p, 3)
        reader = StreamReader(path, "libffm", 8, 4, 50, 4, byte_range=rng)
        shard_lines = sum(
            int(a[4].sum()) for a in reader.batches()
        )
        got.append(shard_lines)
        total += shard_lines
        assert count_lines(path, rng) == shard_lines
    assert total == len(all_lines)
    assert max(got) - min(got) <= 2  # near-even split


def test_count_lines_nonblank(tmp_path):
    """nonblank=True must count exactly the examples the parsers yield."""
    p = str(tmp_path / "b.ffm")
    with open(p, "w") as f:
        f.write("1 0:1:1\n\n0 0:2:1\n   \n\t\n1 0:3:1\n\n")
    assert count_lines(p) == 7
    assert count_lines(p, nonblank=True) == 3
    # unterminated non-blank final line
    with open(p, "a") as f:
        f.write("0 0:4:1")
    assert count_lines(p, nonblank=True) == 4
    # block-boundary carry: a long blank run and a long line
    with open(p, "w") as f:
        f.write(" " * 100 + "\n" + "1 " + "0:1:1 " * 50 + "\n\n")
    assert count_lines(p, nonblank=True) == 1


def test_ranged_load_file_matches_full(tmp_path):
    path = _write_fixed_width_ffm(tmp_path / "d.ffm", n=100)
    full = load_file(path, "libffm", 4, 50, 4)
    parts = [
        load_file(path, "libffm", 4, 50, 4, byte_range=process_byte_range(path, p, 2))
        for p in range(2)
    ]
    np.testing.assert_array_equal(
        np.concatenate([p.feats for p in parts]), full.feats
    )
    np.testing.assert_array_equal(np.concatenate([p.y for p in parts]), full.y)


def _single_process_ref(data):
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    cfg = Config(
        train_data=data, eval_data=data, model_type="FFM", n_fields=4,
        n_feats=50, n_factors=4, batch_size=256, n_epochs=2, online=True,
    )
    return Trainer(cfg).train()


def _run_processes(tmp_path, data, extra_args=(), nprocs=2, dev_per_proc=4):
    """Launch N jax.distributed CPU workers; return their history dicts."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={dev_per_proc}"
    )
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    worker = os.path.join(REPO, "tests", "multihost_worker.py")
    outs = [str(tmp_path / f"hist{p}.json") for p in range(nprocs)]
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(nprocs), str(p), data,
             outs[p], *map(str, extra_args)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for p in range(nprocs)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        logs.append(out.decode())
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    return [json.load(open(path)) for path in outs]


def _run_two_processes(tmp_path, data, extra_args=()):
    return _run_processes(tmp_path, data, extra_args)


def test_two_process_distributed_matches_single(tmp_path):
    data = _write_fixed_width_ffm(tmp_path / "train.ffm", n=256)
    ref = _single_process_ref(data)

    for hist in _run_two_processes(tmp_path, data):
        assert hist["process_count"] == 2
        assert hist["device_count"] == 8
        assert hist["local_device_count"] == 4
        # 256 lines in ONE global batch of 256 (128 per process): identical
        # math to the single-process run up to f32 reassociation
        np.testing.assert_allclose(
            hist["train_loss"], ref["train_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_loss"], ref["eval_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_auc"], ref["eval_auc"], rtol=1e-4
        )


def test_two_process_sharded_checkpoint(tmp_path):
    """Multi-host checkpointing on a model-sharded mesh: all processes join
    the state allgather, the coordinator alone writes, and the saved tables
    equal a single-process run's (the mesh-independent checkpoint
    contract)."""
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.io.checkpoint import load_checkpoint
    from ftrl_ffm_tpu.train import Trainer

    data = _write_fixed_width_ffm(tmp_path / "train.ffm", n=256)
    ckpt = str(tmp_path / "mh.ckpt")
    _run_two_processes(tmp_path, data, extra_args=(2, "route", ckpt))
    assert os.path.exists(ckpt)

    cfg = Config(
        train_data=data, eval_data=data, model_type="FFM", n_fields=4,
        n_feats=50, n_factors=4, batch_size=256, n_epochs=2, online=True,
    )
    ref = Trainer(cfg)
    ref.train()
    ref_state = ref.logical_state  # the documented export boundary
    state, _ = load_checkpoint(ckpt)
    assert state.lin_z.shape == (50,)
    # reassociation tolerance: sharded psum/all_to_all sums accumulate f32
    # z in a different order than the single-device scatter (measured rel
    # ~3e-4 on near-cancelling entries); the target here is the allgather/
    # deinterleave SAVE path — gross structural errors (wrong rows, stale
    # shards, physical order, uneven byte splits changing batch boundaries)
    # would be orders of magnitude off
    for name in ("lin_z", "lin_n", "vec_z", "vec_n", "vec_w"):
        np.testing.assert_allclose(
            np.asarray(getattr(state, name)),
            np.asarray(getattr(ref_state, name)),
            rtol=1e-3, atol=1e-5, err_msg=name,
        )
    assert int(state.step) == int(ref.state.step)


def test_two_process_dynamic_compact_transfer_matches_single(tmp_path):
    """Multi-host dynamic narrowing: epoch 1 observes the stream (static
    uploads), one allgather agrees the contract, epochs 2+ upload uint16
    delta ids / int8 values — and losses still match the single-process run
    (narrowing is lossless by construction)."""
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    data = _write_fixed_width_ffm(tmp_path / "train.ffm", n=256)
    cfg = Config(
        train_data=data, eval_data=data, model_type="FFM", n_fields=4,
        n_feats=50, n_factors=4, batch_size=256, n_epochs=3, online=True,
    )
    ref = Trainer(cfg).train()

    for hist in _run_two_processes(
        tmp_path, data, extra_args=(1, "auto", "", "", 3)
    ):
        agreed = hist["compact_agreed"]
        # the fixture is all-1.0-valued with small per-column id ranges:
        # every dynamic narrowing must have been agreed
        assert agreed["train"]["delta"] is True
        assert agreed["train"]["int8"] is True
        assert agreed["train"]["sw"] is True
        assert agreed["eval"]["delta"] is True
        np.testing.assert_allclose(
            hist["train_loss"], ref["train_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_loss"], ref["eval_loss"], rtol=2e-5
        )


def test_two_process_ordered_predict_file_byte_identical(tmp_path):
    """Multi-host predict_file: 2 processes score their byte-range slices in
    lockstep, the coordinator seek-writes fixed-width lines at global
    offsets — output must be byte-identical to a single-process run on the
    same mesh shape.  Predict-only (n_epochs=0): the init state is
    deterministic across process counts, so byte equality pins the
    ordering/assembly; trained states would reassociate f32 sums across
    process boundaries and make the last %.6f digit flaky."""
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    # 300 lines: an uneven final batch per process (150 = 128 + 22 valid)
    # exercises cross-batch ordering and padded-tail masking.  Blank lines
    # injected: the parsers skip them, so the row counts must come from the
    # nonblank line count or every later offset shifts (code-review fix).
    data = _write_fixed_width_ffm(tmp_path / "score.ffm", n=300)
    content = open(data).readlines()
    content.insert(10, "\n")
    content.insert(200, "   \n")
    with open(data, "w") as f:
        f.writelines(content)
    cfg = Config(
        train_data=data, model_type="FFM", n_fields=4, n_feats=50,
        n_factors=4, batch_size=256, online=True, mesh_data=0, mesh_model=2,
    )
    ref_out = str(tmp_path / "ref_pred.txt")
    assert Trainer(cfg).predict_file(data, ref_out) == 300

    pred = str(tmp_path / "mh_pred.txt")
    _run_two_processes(tmp_path, data, extra_args=(2, "auto", "", pred, 0))
    got = open(pred, "rb").read()
    want = open(ref_out, "rb").read()
    assert len(got) == len(want) == 9 * 300
    assert got == want


def test_two_process_lr_zero_width_fields(tmp_path):
    """LR multi-host: the zero-width fields upload ([B, 0] — LR's math has
    no field dimension) must survive cross-process global-batch assembly,
    and losses must match a single-process LR run."""
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    data = _write_fixed_width_ffm(tmp_path / "train.ffm", n=256)
    cfg = Config(
        train_data=data, eval_data=data, model_type="LR", n_fields=4,
        n_feats=50, n_factors=4, batch_size=256, n_epochs=2, online=True,
    )
    ref = Trainer(cfg).train()
    for hist in _run_two_processes(
        tmp_path, data, extra_args=(1, "auto", "", "", 2, "LR")
    ):
        np.testing.assert_allclose(
            hist["train_loss"], ref["train_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_loss"], ref["eval_loss"], rtol=2e-5
        )


def test_two_process_cli_predict_writes_output(tmp_path):
    """The CLI itself must run --predict_data under --coordinator_address
    (it used to skip it with a warning; train.py has had a working
    multi-host scoring path since round 3)."""
    data = _write_fixed_width_ffm(tmp_path / "train.ffm", n=128)
    out = str(tmp_path / "preds.txt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ftrl_ffm_tpu",
             "--coordinator_address", coord, "--num_processes", "2",
             "--process_id", str(p), "--train_data", data,
             "--model_type", "FFM", "--n_fields", "4", "--n_feats", "50",
             "--n_factors", "4", "--batch_size", "128", "--n_epochs", "1",
             "--predict_data", data, "--predict_output", out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for p in range(2)
    ]
    logs = [p.communicate(timeout=540)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"CLI worker failed:\n{log}"
    lines = open(out).read().splitlines()
    assert len(lines) == 128
    assert all(0.0 <= float(x) <= 1.0 for x in lines)


def test_two_process_route_sharded_matches_single(tmp_path):
    """The full production shape executed for real: 2 processes, tables
    row-sharded over mesh_model=2 with all_to_all routed lookups (a
    (4 data x 2 model) mesh spanning both processes), vs the plain
    single-device run."""
    data = _write_fixed_width_ffm(tmp_path / "train.ffm", n=256)
    ref = _single_process_ref(data)

    for hist in _run_two_processes(tmp_path, data, extra_args=(2, "route")):
        assert hist["process_count"] == 2
        assert hist["device_count"] == 8
        np.testing.assert_allclose(
            hist["train_loss"], ref["train_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_loss"], ref["eval_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_auc"], ref["eval_auc"], rtol=1e-4
        )


def test_four_process_route_inplace_matches_single(tmp_path):
    """The production scaling shape executed as a REAL
    4-process jax.distributed run — a (1, 4) mesh spanning 4 processes
    (one device each), unique-id routed lookups, in-place huge-shard
    update — must match the single-process run's losses AND final state.
    Closes the gap between the 2-process tier and the 8-device
    single-host virtual-mesh tier."""
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.io.checkpoint import load_checkpoint
    from ftrl_ffm_tpu.train import Trainer

    data = _write_fixed_width_ffm(tmp_path / "train.ffm", n=256)
    cfg = Config(
        train_data=data, eval_data=data, model_type="FFM", n_fields=4,
        n_feats=50, n_factors=4, batch_size=256, n_epochs=2, online=True,
    )
    ref = Trainer(cfg)
    ref_hist = ref.train()
    ref_state = ref.logical_state

    ckpt = str(tmp_path / "mh4.ckpt")
    hists = _run_processes(
        tmp_path, data, nprocs=4, dev_per_proc=1,
        extra_args=(4, "route", ckpt, "", 2, "FFM", "inplace"),
    )
    for hist in hists:
        assert hist["process_count"] == 4
        assert hist["device_count"] == 4
        assert hist["local_device_count"] == 1
        np.testing.assert_allclose(
            hist["train_loss"], ref_hist["train_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_loss"], ref_hist["eval_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_auc"], ref_hist["eval_auc"], rtol=1e-4
        )
    # final state equality via the multi-host checkpoint (same tolerance
    # rationale as test_two_process_sharded_checkpoint: f32 reassociation
    # across psum/all_to_all vs the single-device scatter order)
    state, _ = load_checkpoint(ckpt)
    assert state.lin_z.shape == (50,)
    for name in ("lin_z", "lin_n", "vec_z", "vec_n", "vec_w"):
        np.testing.assert_allclose(
            np.asarray(getattr(state, name)),
            np.asarray(getattr(ref_state, name)),
            rtol=1e-3, atol=1e-5, err_msg=name,
        )
    assert int(state.step) == int(ref.state.step)


def test_two_process_device_cache_shard_matches_single(tmp_path):
    """Multi-process device cache: each process splits its byte-range slice
    over its local devices and epochs run from HBM (shard layout, lockstep
    steps).  256 fixed-width lines in ONE global batch, shuffle off: the
    cached composition equals the single-process offline streamed batch in
    file order, so losses must match up to f32 reassociation — and both
    roles (train + eval) must report the shard cache engaged."""
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    data = _write_fixed_width_ffm(tmp_path / "train.ffm", n=256)
    cfg = Config(
        train_data=data, eval_data=data, model_type="FFM", n_fields=4,
        n_feats=50, n_factors=4, batch_size=256, n_epochs=2, online=False,
        shuffle=False, device_cache="off",
    )
    ref = Trainer(cfg).train()

    hists = _run_two_processes(
        tmp_path, data,
        # mesh (1,8) route over both processes; offline, forced cache,
        # shuffle off (argv: mesh_model lookup ckpt pred epochs model
        # update online device_cache shuffle)
        extra_args=(8, "route", "", "", 2, "FFM", "auto", 0, "on", 0),
    )
    for hist in hists:
        assert hist["process_count"] == 2
        assert hist["device_cache"] == {"train": "shard", "eval": "shard"}
        np.testing.assert_allclose(
            hist["train_loss"], ref["train_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_loss"], ref["eval_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_auc"], ref["eval_auc"], rtol=1e-4
        )


def test_four_process_device_cache_shard_matches_single(tmp_path):
    """Cached twin of the 4-process streamed tier: a (1, 4) mesh spanning
    4 processes (one device each, d_local=1), routed lookups, the whole
    dataset resident across the processes' device memories."""
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    data = _write_fixed_width_ffm(tmp_path / "train.ffm", n=256)
    cfg = Config(
        train_data=data, eval_data=data, model_type="FFM", n_fields=4,
        n_feats=50, n_factors=4, batch_size=256, n_epochs=2, online=False,
        shuffle=False, device_cache="off",
    )
    ref = Trainer(cfg).train()

    hists = _run_processes(
        tmp_path, data, nprocs=4, dev_per_proc=1,
        extra_args=(4, "route", "", "", 2, "FFM", "auto", 0, "on", 0),
    )
    for hist in hists:
        assert hist["process_count"] == 4
        assert hist["device_cache"] == {"train": "shard", "eval": "shard"}
        np.testing.assert_allclose(
            hist["train_loss"], ref["train_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_loss"], ref["eval_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(hist["eval_auc"], ref["eval_auc"], rtol=1e-4)


def test_two_process_online_device_cache_matches_single_streamed(tmp_path):
    """ONLINE multi-process device cache (round 4): epoch 1 parses each
    process's byte-range slice once, epochs replay the HBM-resident shards
    in FILE ORDER (stream semantics — no shuffle regardless of
    Config.shuffle).  Losses must match the single-process streamed online
    run: 256 fixed-width lines fit ONE global batch, so the cached shard
    composition equals the streamed batch."""
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    data = _write_fixed_width_ffm(tmp_path / "train.ffm", n=256)
    cfg = Config(
        train_data=data, eval_data=data, model_type="FFM", n_fields=4,
        n_feats=50, n_factors=4, batch_size=256, n_epochs=2, online=True,
        device_cache="off",
    )
    ref = Trainer(cfg).train()

    hists = _run_two_processes(
        tmp_path, data,
        # online=1, device_cache=on, shuffle=1 (must be ignored: online
        # replay is stream-order by construction)
        extra_args=(8, "route", "", "", 2, "FFM", "auto", 1, "on", 1),
    )
    for hist in hists:
        assert hist["process_count"] == 2
        assert hist["device_cache"] == {"train": "shard", "eval": "shard"}
        np.testing.assert_allclose(
            hist["train_loss"], ref["train_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(
            hist["eval_loss"], ref["eval_loss"], rtol=2e-5
        )
        np.testing.assert_allclose(hist["eval_auc"], ref["eval_auc"], rtol=1e-4)
