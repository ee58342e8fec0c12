"""Smoke test of the FTRL trainer on one NVIDIA GPU.

Drives the main path through the entry points a user calls (cli.main and
Trainer) at the flagship FFM width (39 fields, C'=40, K=16, E=640,
B=16384), with data made from a seed, and checks every result against
the repo's own references:

  kernels     each kernel, compiled for the card, vs its plain XLA
              reference (ops/interactions.py::ffm_logits_and_grads); the
              in-place update on a table past 2^31 elements vs a float64
              reference; the DEC6 decode vs the host
  train 100k  2 online epochs (epoch 2 replays the device cache) + eval +
              --predict_data, fused kernel vs --use_pallas off
  train 1M    the same at 1M rows (7.7 GB of state): the in-place update
              vs --update_mode dense
  checkpoint  save, load, resume one step: CLI vs Trainer
  gpu tests   the `gpu`-marked tests, in this process

Each phase prints the numbers it compares and their tolerance; any failure
makes the exit code non-zero.  The last line is the JSON result.  Without a
GPU the script exits non-zero before any phase.

    python chip_smoke.py              # one card, all phases
    python chip_smoke.py --multi 4    # four cards: the sharded route-mode
                                      # trainer vs one card, nothing else
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

N_FIELDS, C_PAD, N_FACTORS, BATCH = 39, 40, 16, 16384
N_ROWS = 100_000  # training rows per run: 7 batches, the last one ragged
SMALL, LARGE = 100_000, 1_000_000  # table rows of the two training phases
# kernel vs reference, f32 (the interpret-mode tests' bounds)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
PAYLOAD_TOL = dict(rtol=1e-4, atol=1e-6)
# two numerically different but equivalent paths over a whole run.  On the
# H100 the per-epoch losses agreed to 2e-8 (relative), the AUCs to 1.3e-7
# and the probabilities to the prediction file's last digit (%.6f, 1e-6);
# the margin left is for the GPU's atomic scatter-adds, which sum the
# per-row gradients in a different order on every run
LOSS_RTOL = 1e-6
AUC_ATOL = 1e-6
PROB_ATOL = 2e-6
RESUME_TOL = dict(rtol=1e-5, atol=1e-5)
# FTRL alpha of the training phases: large enough that two epochs learn
# the data's labelling model (the default 1e-4 barely moves the loss)
ALPHA = "0.05"
MIN_AUC = 0.55  # last-epoch eval AUC of every run (chance: 0.5)


def say(*a) -> None:
    print(*a, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def within(got, want, rtol: float, atol: float):
    """(ok, max |got - want|, worst |got - want| / (atol + rtol |want|))."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    ratio = float(np.max(err / (atol + rtol * np.abs(want)))) if err.size else 0.0
    return ratio <= 1.0, float(err.max()) if err.size else 0.0, ratio


def report(name: str, got, want, rtol: float, atol: float) -> bool:
    ok, err, ratio = within(got, want, rtol, atol)
    say(f"  {name}: max abs err {err:.3e}, worst err/tol {ratio:.3f} "
        f"(rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------- phases
def phase_kernels() -> bool:
    import jax
    import jax.numpy as jnp

    from ftrl_ffm_tpu.ops.ffm_pallas import ffm_fused_logits, ffm_fused_logits_grads
    from ftrl_ffm_tpu.ops.interactions import ffm_logits_and_grads

    b, f, c, k = 2048, N_FIELDS, C_PAD, N_FACTORS
    e = c * k
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=(b, f, e)).astype(np.float32) * 0.1)
    fields = jnp.asarray(rng.integers(0, N_FIELDS, (b, f)).astype(np.int32))
    vals = jnp.asarray(rng.random((b, f)).astype(np.float32))
    lin = jnp.asarray(rng.normal(size=(b,)).astype(np.float32) * 0.1)
    y = jnp.asarray((rng.random(b) > 0.5).astype(np.float32))
    sw = jnp.asarray((rng.random(b) > 0.2).astype(np.float32))
    ok = True
    for aug in (-1, N_FIELDS):
        ref, dv = jax.jit(
            ffm_logits_and_grads, static_argnums=(4, 5, 6),
            static_argnames=("grad_lane",),
        )(v, fields, vals, lin, c, k, True, grad_lane=aug)
        g = (((jax.nn.sigmoid(ref) - y) * sw)[:, None, None] * dv).reshape(b * f, e)
        logits, gg2 = ffm_fused_logits_grads(
            v.reshape(b * f, e), fields, vals, lin, y, sw, c, k, aug_lane=aug
        )
        say(f" ffm_fused_logits_grads B={b} F={f} C'={c} K={k} aug_lane={aug}")
        ok &= report("logits", logits, ref, **LOGIT_TOL)
        ok &= report("g", gg2[:, :e], g, **PAYLOAD_TOL)
        ok &= report("g^2", gg2[:, e:], g * g, **PAYLOAD_TOL)
    ref, _ = ffm_logits_and_grads(v, fields, vals, lin, c, k, False)
    got = ffm_fused_logits(v.reshape(b * f, e), fields, vals, lin, c, k)
    say(f" ffm_fused_logits B={b}")
    ok &= report("logits", got, ref, **LOGIT_TOL)
    return ok & check_inplace_past_int32() & check_dec6()


def check_inplace_past_int32() -> bool:
    """The in-place update (ftrl.py::dense_ftrl_update_inplace) on a
    3.4M x 640 table, past 2^31 elements: the rows at both ends, touched
    and not, vs a float64 numpy reference of the same FTRL step."""
    import jax
    import jax.numpy as jnp

    from ftrl_ffm_tpu.ftrl import FtrlParams, dense_ftrl_update_inplace

    r, d, p = 3_400_000, C_PAD * N_FACTORS, FtrlParams(alpha=float(ALPHA))
    rng = np.random.default_rng(5)
    pick = np.concatenate([np.arange(512), np.arange(r - 4096, r)])
    ids = rng.choice(pick, 8192).astype(np.int32)  # duplicates sum
    g = rng.normal(0, 0.1, (ids.size, d)).astype(np.float32)
    init = [np.abs(rng.normal(0, 1, (pick.size, d))),
            rng.normal(0, 1, (pick.size, d)),
            rng.normal(0, 0.01, (pick.size, d))]
    init = [x.astype(np.float32) for x in init]
    init[0][:64] = 0.0  # rows never touched before: keep_init

    @jax.jit
    def table(rows):
        return jnp.zeros((r, d), jnp.float32).at[pick].set(rows)

    tabs = [table(x) for x in init]
    upd = jax.jit(dense_ftrl_update_inplace, static_argnums=6,
                  donate_argnums=(0, 1, 2))
    got = upd(*tabs, jnp.asarray(ids), jnp.asarray(g), jnp.asarray(g * g), p)
    got = [np.asarray(jnp.take(t, jnp.asarray(pick), axis=0)) for t in got]
    del tabs
    # float64 reference on the picked rows only
    n, z, w = (x.astype(np.float64) for x in init)
    pos = np.searchsorted(pick, ids)
    sg, sg2 = np.zeros_like(n), np.zeros_like(n)
    np.add.at(sg, pos, g.astype(np.float64))
    np.add.at(sg2, pos, (g * g).astype(np.float64))
    sigma = (np.sqrt(n + sg2) - np.sqrt(n)) / p.alpha
    z = z + sg - sigma * w
    n = n + sg2
    wc = -(z - np.sign(z) * p.l1) / (p.l2 + (p.beta + np.sqrt(n)) / p.alpha)
    wc = np.where(np.abs(z) <= p.l1, 0.0, wc)
    w = np.where(n > 1e-16, wc, w)
    say(f" dense_ftrl_update_inplace R={r} D={d} ({r * d} elements): "
        f"{pick.size} rows at both ends, {np.unique(ids).size} touched")
    ok = True
    for name, x, y in zip("nzw", got, (n, z, w)):
        ok &= report(name, x, y, rtol=1e-5, atol=1e-6)
    return ok


def check_dec6() -> bool:
    """dec6_decode on the card == the host's correctly rounded k / 1e6 for
    every k < 2^24 (the exactness the DEC6 upload tier relies on)."""
    import jax
    import jax.numpy as jnp

    from ftrl_ffm_tpu.models.base import dec6_decode

    k = np.arange(1 << 24, dtype=np.int32)
    dev = np.asarray(jax.jit(dec6_decode)(jnp.asarray(k)))
    bad = int(np.count_nonzero(dev != k.astype(np.float32) / np.float32(1e6)))
    say(f" dec6_decode: {bad} of {k.size} ks differ from the host division "
        f"{'ok' if bad == 0 else 'FAIL'}")
    return bad == 0


_RUNS: list = []


def _record_trains() -> None:
    """Keep each Trainer.train history (cli.main prints rounded losses)."""
    from ftrl_ffm_tpu.train import Trainer

    orig = Trainer.train

    def train(self, profile_dir=None):
        hist = orig(self, profile_dir)
        _RUNS.append((self, hist))
        return hist

    Trainer.train = train


def run_cli(argv: list) -> tuple:
    """cli.main(argv) -> (history, its Trainer); prints the CLI's tail."""
    from ftrl_ffm_tpu import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}: {buf.getvalue()[-2000:]}")
    tr, hist = _RUNS.pop()
    say(f"  {time.perf_counter() - t0:.1f}s wall: "
        + " | ".join(ln for ln in buf.getvalue().splitlines()
                     if ln.startswith("epoch")))
    return hist, tr


def model_flags(n_feats: int) -> list:
    return [
        "--model_type", "FFM", "--n_fields", str(N_FIELDS),
        "--n_feats", str(n_feats), "--n_factors", str(N_FACTORS),
        "--batch_size", str(BATCH), "--max_nnz", str(N_FIELDS),
        "--online", "true", "--n_threads", "4", "--w_alpha", ALPHA,
    ]


def print_kind(n_feats: int, mode: str) -> None:
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.ftrl import select_update_kind
    from ftrl_ffm_tpu.ops.ffm_pallas import resolve_use_pallas

    cfg = Config(model_type="FFM", n_fields=N_FIELDS, n_factors=N_FACTORS)
    kind = select_update_kind(n_feats, cfg.row_width, BATCH * N_FIELDS, mode)
    say(f"  update_mode={mode} -> {kind} at {n_feats} rows; "
        f"use_pallas=auto -> {'kernel' if resolve_use_pallas('auto') else 'XLA'}")


def compare_runs(a: tuple, b: tuple, label: str) -> bool:
    (ha, pa), (hb, pb) = a, b
    say(f"  {label}: train loss {ha['train_loss']} vs {hb['train_loss']}")
    say(f"  {label}: eval loss {ha['eval_loss']} vs {hb['eval_loss']}, "
        f"auc {ha['eval_auc']} vs {hb['eval_auc']}")
    ok = report("train loss", ha["train_loss"], hb["train_loss"], LOSS_RTOL, 0.0)
    ok &= report("eval loss", ha["eval_loss"], hb["eval_loss"], LOSS_RTOL, 0.0)
    ok &= report("eval auc", ha["eval_auc"], hb["eval_auc"], 0.0, AUC_ATOL)
    ok &= report(f"{pa.size} predictions", pa, pb, 0.0, PROB_ATOL)
    for h in (ha, hb):
        learned = h["eval_auc"][-1] > MIN_AUC
        say(f"  last-epoch eval auc {h['eval_auc'][-1]:.4f} > {MIN_AUC} "
            f"(the model learned) {'ok' if learned else 'FAIL'}")
        ok &= learned
    return ok


def train_pair(tmp: str, n_feats: int, tag: str, variants: dict,
               keep_state: str = "") -> tuple:
    """Train the same data once per variant through cli.main and compare.
    Returns (ok, {variant: host logical state} for `keep_state`)."""
    from bench import write_criteo

    t0 = time.perf_counter()
    # train and eval rows come from one labelling model: split one file
    both = write_criteo(os.path.join(tmp, f"{tag}.ffm"), N_ROWS + 2 * BATCH,
                        n_feats)
    train, ev = (os.path.join(tmp, f"{tag}_{x}.ffm") for x in ("train", "eval"))
    with open(both) as src, open(train, "w") as tr_f, open(ev, "w") as ev_f:
        for i, line in enumerate(src):
            (tr_f if i < N_ROWS else ev_f).write(line)
    say(f"  data: {N_ROWS} train + {2 * BATCH} eval rows over {n_feats} ids, "
        f"one labelling model ({time.perf_counter() - t0:.1f}s)")
    results, kept = {}, {}
    for name, extra in variants.items():
        pred = os.path.join(tmp, f"{tag}_{name}.pred")
        argv = model_flags(n_feats) + [
            "--train_data", train, "--eval_data", ev, "--n_epochs", "2",
            "--predict_data", ev, "--predict_output", pred,
        ] + extra
        hist, tr = run_cli(argv)
        if name == keep_state:
            import jax

            kept["state"] = jax.device_get(tr.logical_state)
            kept["train"] = train
        cached = tr._dev_cache.get("train") is not None
        say(f"  {name}: device-cache replay on epoch 2: {cached}")
        if not cached:
            raise RuntimeError("epoch 2 did not take the device-cache path")
        del tr
        gc.collect()
        results[name] = (hist, np.loadtxt(pred))
    a, b = list(results)
    return compare_runs(results[a], results[b], f"{a} vs {b}"), kept


def phase_train_100k(tmp: str) -> tuple:
    print_kind(SMALL, "auto")
    ck = os.path.join(tmp, "ck100k.ckpt")
    ok, kept = train_pair(
        tmp, SMALL, "r100k",
        {"kernel": ["--use_pallas", "auto", "--model_path", ck],
         "xla": ["--use_pallas", "off"]},
        keep_state="kernel",
    )
    kept["ckpt"] = ck
    return ok, kept


def phase_train_1m(tmp: str) -> bool:
    print_kind(LARGE, "auto")
    print_kind(LARGE, "dense")
    ok, _ = train_pair(
        tmp, LARGE, "r1m",
        {"inplace": ["--update_mode", "auto"],
         "dense": ["--update_mode", "dense"]},
    )
    return ok


def phase_checkpoint(tmp: str, kept: dict) -> bool:
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.io.checkpoint import load_checkpoint, validate_header_compat
    from ftrl_ffm_tpu.train import Trainer

    ck = kept["ckpt"]
    state, extra = load_checkpoint(ck)
    ok = True
    for name, got, want in zip(state._fields, state, kept["state"]):
        if got is None:
            continue
        same = np.array_equal(np.asarray(got), np.asarray(want))
        ok &= same
        if not same:
            say(f"  save->load {name}: differs from the trained state FAIL")
    say(f"  save->load: every table bit-identical to the trained state: {ok}")
    one = os.path.join(tmp, "one_batch.ffm")
    with open(kept["train"]) as src, open(one, "w") as dst:
        for _ in range(BATCH):
            dst.write(src.readline())
    a_path, b_path = (os.path.join(tmp, f"resume_{x}.ckpt") for x in "ab")
    run_cli(model_flags(SMALL) + [
        "--load_model", ck, "--train_data", one, "--n_epochs", "1",
        "--model_path", a_path,
    ])
    cfg = Config(
        train_data=one, model_type="FFM", n_fields=N_FIELDS, n_feats=SMALL,
        n_factors=N_FACTORS, batch_size=BATCH, max_nnz=N_FIELDS, n_epochs=1,
        n_threads=4, w_alpha=float(ALPHA),
    )
    validate_header_compat(cfg, extra, ck)
    tr = Trainer(cfg, state=state)
    tr.train()
    tr.save_checkpoint(b_path)
    _RUNS.clear()
    del tr
    gc.collect()
    sa, _ = load_checkpoint(a_path)
    sb, _ = load_checkpoint(b_path)
    moved = int(np.asarray(sa.step)) - int(np.asarray(state.step))
    say(f"  resumed at step {int(np.asarray(state.step))}, +{moved} step(s)")
    ok &= moved == 1
    identical = True
    for name, x, y in zip(sa._fields, sa, sb):
        if x is None:
            continue
        identical &= np.array_equal(x, y)
        # the GPU's scatter-adds are atomic: two runs of one step round the
        # per-row gradient sums in different orders (a few f32 ulps of
        # the O(1) accumulators), so the resumes agree to RESUME_TOL
        ok &= report(f"resume CLI vs Trainer {name}", x, y, **RESUME_TOL)
    say(f"  two resumes of the same step bit-identical: {identical}")
    return ok


def phase_gpu_tests() -> bool:
    import pytest

    os.environ["FTRL_FFM_TEST_PLATFORM"] = "gpu"
    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider",
        os.path.join(HERE, "tests", "test_gpu.py"),
    ])
    say(f"  pytest -m gpu exit code {int(rc)}")
    return int(rc) == 0


# ------------------------------------------------------------- four cards
def multi_compare(tmp: str, n_feats: int, n_rows: int, cards: int) -> bool:
    """The sharded route-mode trainer on `cards` cards vs one card, same
    batches: per-epoch loss and the touched rows of lin_z / vec_z."""
    import jax

    from bench import write_criteo
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    path = write_criteo(os.path.join(tmp, "multi.ffm"), n_rows, n_feats)
    with open(path) as f:
        ids = [int(t.split(":")[1]) for ln in f for t in ln.split()[1:]]
    touched = np.unique(np.asarray(ids, np.int64))
    kw = dict(
        train_data=path, model_type="FFM", n_fields=N_FIELDS,
        n_feats=n_feats, n_factors=N_FACTORS, batch_size=BATCH,
        max_nnz=N_FIELDS, n_epochs=1, online=True, n_threads=4,
        w_alpha=float(ALPHA),
    )
    out = {}
    for name, extra in (
        ("one card", {}),
        (f"{cards} cards", dict(mesh_data=1, mesh_model=cards,
                                lookup_mode="route")),
    ):
        t0 = time.perf_counter()
        tr = Trainer(Config(**kw, **extra))
        hist = tr.train()
        st = tr.logical_state

        def rows_of(x):
            if isinstance(x, jax.Array):  # one card: select on the device
                return np.asarray(jax.numpy.take(x, touched, axis=0))
            return np.asarray(x)[touched]

        out[name] = dict(
            loss=hist["train_loss"],
            overflow=sum(hist["route_overflow"]),
            lin_z=rows_of(st.lin_z),
            vec_z=rows_of(st.vec_z),
        )
        del tr, st
        gc.collect()
        jax.clear_caches()
        used = jax.devices()[0].memory_stats() or {}
        say(f"  {name}: {time.perf_counter() - t0:.1f}s, train loss "
            f"{hist['train_loss']}, route overflow {out[name]['overflow']}, "
            f"card 0 bytes in use after free {used.get('bytes_in_use')}")
    a, b = out.values()
    say(f"  {touched.size} touched rows of {n_feats}")
    ok = b["overflow"] == 0
    ok &= report("train loss", b["loss"], a["loss"], 1e-5, 0.0)
    # z sums O(1) gradient terms in a different order on each mesh: where
    # they cancel, a small z keeps a few ulps of O(1) as absolute error
    ok &= report("lin_z (touched rows)", b["lin_z"], a["lin_z"], 1e-4, 2e-6)
    ok &= report("vec_z (touched rows)", b["vec_z"], a["vec_z"], 1e-4, 1e-6)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description="FTRL trainer smoke test on GPU")
    ap.add_argument("--multi", type=int, default=0,
                    help="run only the sharded route-mode check on N cards")
    args = ap.parse_args()

    import jax

    import ftrl_ffm_tpu  # noqa: F401  (fails outside a checkout)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    want = args.multi or 1
    if len(devs) < want:
        print(f"needs {want} GPUs, found {len(devs)}", file=sys.stderr)
        return 2

    from ftrl_ffm_tpu import native
    from ftrl_ffm_tpu.train import default_cache_dir, enable_compilation_cache

    enable_compilation_cache()
    say(f"card: {card()}")
    say(f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    say("compile cache: " + (os.environ.get("JAX_COMPILATION_CACHE_DIR")
                             or default_cache_dir()))
    say("parser: " + ("native (g++ build of native/parser.cpp)"
                      if native.lib() is not None else "numpy"))

    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        if args.multi:
            phases = [(f"{args.multi} cards, route mesh (1, {args.multi}), "
                       "4M rows",
                       lambda: multi_compare(tmp, 4_000_000, 4 * BATCH,
                                             args.multi))]
        else:
            _record_trains()
            kept: dict = {}

            def train_100k():
                ok, got = phase_train_100k(tmp)
                kept.update(got)
                return ok

            phases = [
                ("kernels", phase_kernels),
                ("train 100k rows", train_100k),
                ("checkpoint", lambda: phase_checkpoint(tmp, kept)),
                ("train 1M rows", lambda: phase_train_1m(tmp)),
                ("gpu tests", phase_gpu_tests),
            ]
        for name, fn in phases:
            say(f"phase {name}")
            t0 = time.perf_counter()
            try:
                ok = bool(fn())
            except Exception:
                traceback.print_exc()
                ok = False
            say(f"phase {name}: {'ok' if ok else 'FAILED'} "
                f"({time.perf_counter() - t0:.1f}s)")
            if not ok:
                failed.append(name)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
