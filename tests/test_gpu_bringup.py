"""CPU tests of what the GPU path decides on the host: the compile-cache
location, use_pallas resolution, device-memory budgets, the kernels'
ragged-batch masking (interpret mode), the libzstd binding, the peak-rate
table, the multi-process card assignment, and chip_smoke.py refusing to
run without a GPU."""

import io
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ compile cache
@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_location(env_set, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: the program sets no directory (JAX
    reads the variable itself).  Unset: the fixed in-checkout path."""
    import ftrl_ffm_tpu.train as train_mod

    calls = []
    monkeypatch.setattr(train_mod, "_cache_enabled", False)
    monkeypatch.setattr(
        train_mod.jax.config, "update", lambda k, v: calls.append((k, v))
    )
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    train_mod.enable_compilation_cache()
    train_mod.enable_compilation_cache()  # idempotent
    if env_set:
        assert calls == []
    else:
        assert calls == [
            ("jax_compilation_cache_dir", os.path.join(REPO, ".jax_cache"))
        ]
        assert os.path.isdir(os.path.join(REPO, ".jax_cache"))


def test_default_cache_dir_is_fixed_and_gitignored():
    from ftrl_ffm_tpu.train import default_cache_dir

    assert default_cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# -------------------------------------------------------- use_pallas resolve
@pytest.mark.parametrize(
    "mode,gpu,want",
    [
        ("auto", True, True),
        ("auto", False, False),
        ("on", True, True),
        ("on", False, RuntimeError),
        ("off", True, False),
        ("off", False, False),
    ],
)
def test_resolve_use_pallas(mode, gpu, want, monkeypatch):
    import ftrl_ffm_tpu.ops.ffm_pallas as fp

    monkeypatch.setattr(fp, "available", lambda: gpu)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="needs a GPU"):
            fp.resolve_use_pallas(mode)
    else:
        assert fp.resolve_use_pallas(mode) is want


def test_use_pallas_on_without_gpu_raises_in_the_step():
    """No silent fallback: the FFM step with use_pallas='on' on the CPU
    fails instead of running the XLA formulation."""
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.models import Batch, make_model

    cfg = Config(model_type="FFM", n_fields=4, n_feats=32, n_factors=4,
                 batch_size=8, max_nnz=4, use_pallas="on")
    model = make_model(cfg)
    batch = Batch(
        fields=jnp.zeros((8, 4), jnp.int32), feats=jnp.zeros((8, 4), jnp.int32),
        vals=jnp.ones((8, 4)), y=jnp.ones((8,)), sample_w=jnp.ones((8,)),
    )
    with pytest.raises(RuntimeError, match="needs a GPU"):
        model.train_step(model.init(), batch)


# ------------------------------------------------------------ device memory
class _FakeDev:
    def __init__(self, platform, stats):
        self.platform, self.device_kind, self._stats = platform, "fake", stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize(
    "platform,stats,want",
    [
        ("cpu", None, None),
        ("gpu", {"bytes_limit": 60 << 30, "bytes_in_use": 1}, 60 << 30),
        ("gpu", {}, RuntimeError),
    ],
)
def test_device_memory_bytes(platform, stats, want):
    from ftrl_ffm_tpu.train import device_memory_bytes

    dev = _FakeDev(platform, stats)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="reports no memory limit"):
            device_memory_bytes(dev)
    else:
        assert device_memory_bytes(dev) == want
    assert device_memory_bytes() is None  # the test platform is the CPU


def test_memory_budgets_follow_the_device_limit(tmp_path, monkeypatch):
    """Preflight warning, device-cache and snapshot budgets are fractions of
    device_memory_bytes(): a tiny limit warns and declines, a large one
    admits."""
    import ftrl_ffm_tpu.train as train_mod
    from ftrl_ffm_tpu.config import Config

    kw = dict(model_type="FFM", n_fields=4, n_feats=64, n_factors=4,
              batch_size=8, max_nnz=4, file_type="libffm")
    monkeypatch.setattr(train_mod, "device_memory_bytes", lambda: 1000)
    with pytest.warns(UserWarning, match="RESOURCE_EXHAUSTED likely"):
        tr = train_mod.Trainer(Config(**kw))
    assert not tr._device_cache_fits(100)
    assert not tr._snapshot_copy_fits(tr.state)
    monkeypatch.setattr(train_mod, "device_memory_bytes", lambda: 80 << 30)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr = train_mod.Trainer(Config(**kw))
    assert tr._device_cache_fits(100)
    assert tr._snapshot_copy_fits(tr.state)


# ------------------------------------------------- kernels: ragged batches
@pytest.mark.parametrize("b,f", [(1, 3), (5, 7), (13, 5)])
def test_kernel_masks_ragged_batches(b, f):
    """Batch and occurrence counts with no power-of-two factor: masks bound
    every load and store (interpret mode), so logits and payload match the
    XLA reference and padded occurrences carry zero gradient."""
    from ftrl_ffm_tpu.ops.ffm_pallas import ffm_fused_logits, ffm_fused_logits_grads
    from ftrl_ffm_tpu.ops.interactions import ffm_logits_and_grads

    c, k = 6, 4
    e = c * k
    rng = np.random.default_rng(b)
    v = jnp.asarray(rng.normal(size=(b, f, e)).astype(np.float32) * 0.1)
    fields = jnp.asarray(rng.integers(0, c - 1, (b, f)).astype(np.int32))
    vals_np = rng.random((b, f)).astype(np.float32)
    vals_np[:, -1] = 0.0  # a padded occurrence in every sample
    vals = jnp.asarray(vals_np)
    lin = jnp.asarray(rng.normal(size=(b,)).astype(np.float32))
    y = jnp.asarray((rng.random(b) > 0.5).astype(np.float32))
    sw = jnp.ones((b,), jnp.float32)
    ref, dv = ffm_logits_and_grads(v, fields, vals, lin, c, k, True,
                                   grad_lane=c - 1)
    g_ref = ((jax.nn.sigmoid(ref) - y) * sw)[:, None, None] * dv
    logits, gg2 = ffm_fused_logits_grads(
        v.reshape(b * f, e), fields, vals, lin, y, sw, c, k,
        interpret=True, aug_lane=c - 1,
    )
    np.testing.assert_allclose(logits, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        gg2[:, :e].reshape(b, f, e), g_ref, rtol=1e-4, atol=1e-6
    )
    assert float(jnp.abs(gg2.reshape(b, f, 2 * e)[:, -1]).max()) == 0.0
    got = ffm_fused_logits(v.reshape(b * f, e), fields, vals, lin, c, k,
                           interpret=True)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ libzstd binding
def test_zstd_stream_roundtrip_any_dtype():
    from ftrl_ffm_tpu.io import zstd

    rng = np.random.default_rng(0)
    parts = [
        rng.integers(0, 4, 300_000).astype(np.uint8),
        rng.normal(size=(1000, 7)).astype(np.float32),
        rng.normal(size=(513,)).astype(jnp.bfloat16),
    ]
    buf = io.BytesIO()
    with zstd.Writer(buf, level=3) as w:
        w.write(b"header")
        for p in parts:
            w.write(p)
    r = zstd.Reader(io.BytesIO(buf.getvalue()))
    assert r.read(6) == b"header"
    for p in parts:
        out = np.empty_like(p)
        view = out.reshape(-1).view(np.uint8)
        got = 0
        while got < view.size:  # odd-sized reads cross frame buffers
            n = r.readinto(view[got:got + 77_777])
            assert n
            got += n
        np.testing.assert_array_equal(out.view(np.uint8), p.view(np.uint8))
    assert r.read(1) == b""


def test_zstd_one_shot_and_errors():
    from ftrl_ffm_tpu.io import zstd

    raw = bytes(range(256)) * 1000
    blob = zstd.compress(raw, 5)
    assert blob[:4] == b"\x28\xb5\x2f\xfd"  # a plain zstd frame
    assert len(blob) < len(raw)
    assert zstd.decompress(blob) == raw
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(b"\x28\xb5\x2f\xfd" + b"\x00" * 32)


# ------------------------------------------------------------- peak table
def test_peak_table_refuses_unknown_devices():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import peaks
    finally:
        sys.path.pop(0)
    assert peaks.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError, match="no published peak rates"):
        peaks.peaks("cpu")


# ------------------------------------------------- one process per card
def test_cli_passes_local_device_ids(monkeypatch):
    from ftrl_ffm_tpu import cli

    seen = {}

    class Stop(Exception):
        pass

    def initialize(**kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(jax.distributed, "initialize", initialize)
    with pytest.raises(Stop):
        cli.main([
            "--coordinator_address", "localhost:1", "--num_processes", "4",
            "--process_id", "2", "--local_device_ids", "2",
            "--train_data", "x.ffm",
        ])
    assert seen["local_device_ids"] == [2]
    assert seen["process_id"] == 2 and seen["num_processes"] == 4


# ------------------------------------------------------------ chip_smoke.py
@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(alone, tmp_path):
    """On a CPU-only machine, and in a directory holding chip_smoke.py and
    nothing else of the repo, the smoke exits non-zero and prints no
    result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
