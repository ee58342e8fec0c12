"""Parser unit tests (behavioral parity with reference src/data/parser.cpp)."""

import numpy as np
import pytest

from ftrl_ffm_tpu.config import detect_file_type
from ftrl_ffm_tpu.data.parser import parse_text, sniff_max_nnz

LIBFFM = (
    "1 0:3:1 1:7:1 2:9:0.5\n"
    "0 0:4:1 1:8:1 2:9:0.25\n"
    "-1 0:3:1 2:9:1\n"          # label -1 -> 0
    "2 0:3:0 1:7:2.5\n"          # zero-valued feature dropped; label 2 -> 1
)
LIBSVM = "1 3:1 7:1 9:0.5\n0 4:1 8:1 9:0.25\n"


def test_libffm_exact():
    c = parse_text(LIBFFM, "libffm", max_nnz=4, n_feats=10, n_fields=3)
    assert c.y.tolist() == [1.0, 0.0, 0.0, 1.0]
    np.testing.assert_array_equal(c.fields[0, :3], [0, 1, 2])
    np.testing.assert_array_equal(c.feats[0, :3], [3, 7, 9])
    np.testing.assert_allclose(c.vals[0, :3], [1.0, 1.0, 0.5])
    # padding slot
    assert c.feats[0, 3] == 10 and c.vals[0, 3] == 0.0
    # zero-valued feature of line 4 disabled in place
    assert c.feats[3, 0] == 10 and c.vals[3, 0] == 0.0
    assert c.feats[3, 1] == 7 and c.vals[3, 1] == 2.5


def test_libsvm_exact():
    c = parse_text(LIBSVM, "libsvm", max_nnz=3, n_feats=10, n_fields=1)
    assert c.y.tolist() == [1.0, 0.0]
    np.testing.assert_array_equal(c.fields[0], [0, 0, 0])  # dummy field 0
    np.testing.assert_array_equal(c.feats[0], [3, 7, 9])
    np.testing.assert_allclose(c.vals[1], [1.0, 1.0, 0.25])


def test_out_of_range_filtered():
    # feat 99 >= n_feats, field 7 >= n_fields -> disabled (remove_out_range)
    text = "1 0:99:1 7:3:1 1:5:1\n"
    c = parse_text(text, "libffm", max_nnz=3, n_feats=10, n_fields=3)
    assert c.feats[0, 0] == 10 and c.vals[0, 0] == 0.0
    assert c.feats[0, 1] == 10 and c.vals[0, 1] == 0.0
    assert c.feats[0, 2] == 5 and c.vals[0, 2] == 1.0


def test_truncation_beyond_max_nnz():
    text = "1 " + " ".join(f"0:{i}:1" for i in range(8)) + "\n"
    c = parse_text(text, "libffm", max_nnz=4, n_feats=100, n_fields=2)
    assert c.nnz[0] == 8
    np.testing.assert_array_equal(c.feats[0], [0, 1, 2, 3])


def test_malformed_raises():
    with pytest.raises(ValueError):
        parse_text("1 0:3\n", "libffm", 2, 10, 2)  # odd ':' count
    with pytest.raises(ValueError):
        parse_text("abc 0:3:1\n", "libffm", 2, 10, 2)  # non-numeric token


def test_blank_lines_skipped():
    c = parse_text("1 0:1:1\n\n0 1:2:1\n", "libffm", 2, 10, 2)
    assert c.y.shape[0] == 2


def test_detect_file_type(tmp_path):
    # reference: src/utils/cmd_option.cpp:35-59
    p1 = tmp_path / "a.txt"
    p1.write_text(LIBSVM)
    assert detect_file_type(str(p1)) == "libsvm"
    p2 = tmp_path / "b.txt"
    p2.write_text(LIBFFM)
    assert detect_file_type(str(p2)) == "libffm"
    p3 = tmp_path / "c.txt"
    p3.write_text("1 3:4:5:6\n")
    with pytest.raises(ValueError):
        detect_file_type(str(p3))


def test_sniff_max_nnz(tmp_path):
    p = tmp_path / "d.txt"
    p.write_text(LIBFFM)
    assert sniff_max_nnz(str(p), "libffm") == 3
    p.write_text(LIBSVM)
    assert sniff_max_nnz(str(p), "libsvm") == 3


def test_sniff_max_nnz_scans_whole_file(tmp_path):
    """The sniff must see every line: a capped sample would silently
    truncate longer later samples (the reference never truncates)."""
    p = tmp_path / "long.ffm"
    with open(p, "w") as f:
        for _ in range(3000):
            f.write("1 0:1:1\n")
        f.write("0 " + " ".join(f"{c}:{c}:1" for c in range(12)) + "\n")
    assert sniff_max_nnz(str(p), "libffm") == 12
    # legacy capped scan misses it (explicit opt-in only)
    assert sniff_max_nnz(str(p), "libffm", sample_lines=2000) == 1


def test_explicit_max_nnz_truncation_warns(tmp_path):
    """An explicit --max_nnz below the data's true maximum truncates — and
    must warn loudly, once per source (the reference parses every token)."""
    import pytest as _pytest

    from ftrl_ffm_tpu.data.loader import load_file
    from ftrl_ffm_tpu.data.parser import _truncation_warned
    from ftrl_ffm_tpu.data.stream import StreamReader

    p = str(tmp_path / "t.ffm")
    with open(p, "w") as f:
        for i in range(8):
            f.write(f"1 0:{i}:1 1:{i + 8}:1 2:{i + 16}:1\n")
    _truncation_warned.clear()
    with _pytest.warns(UserWarning, match="TRUNCATED"):
        load_file(p, "libffm", max_nnz=2, n_feats=50, n_fields=4)
    _truncation_warned.clear()
    with _pytest.warns(UserWarning, match="TRUNCATED"):
        reader = StreamReader(p, "libffm", 4, 2, 50, 4, log_every=0)
        list(reader.batches())
    _truncation_warned.clear()


# ---------------------------------------------------------------- native path
def test_native_parser_matches_numpy():
    """C++ fast path == numpy ground truth on mixed/quirky input."""
    from ftrl_ffm_tpu.data.parser import parse_text_native, parse_text_numpy

    text = (
        "1 0:12:1 1:507:0.25 2:9:1.5\n"
        "0 0:3:1 0:3:2 1:99999:1\n"          # out-of-range feat disabled
        "-1 2:5:0 1:4:-2.5\n"                 # label<=0 -> 0; zero val dropped
        "3 0:1:1e-2 1:2:0.0001 2:3:123.456\n"  # exponents + decimals
        "\n"
        "1 5:7:1 0:8:1\n"                     # out-of-range field disabled
    )
    nat = parse_text_native(text, "libffm", 4, 1000, 3)
    assert nat is not None, "native parser failed to build/load"
    ref = parse_text_numpy(text, "libffm", 4, 1000, 3)
    np.testing.assert_array_equal(nat.y, ref.y)
    np.testing.assert_array_equal(nat.fields, ref.fields)
    np.testing.assert_array_equal(nat.feats, ref.feats)
    np.testing.assert_allclose(nat.vals, ref.vals, rtol=1e-6)
    np.testing.assert_array_equal(nat.nnz, ref.nnz)


def test_native_parser_matches_numpy_libsvm():
    from ftrl_ffm_tpu.data.parser import parse_text_native, parse_text_numpy

    text = "1 12:1 507:0.25 9:1.5\n0 3:1 99999:1\n1 4:0.125\n"
    nat = parse_text_native(text, "libsvm", 3, 1000, 1)
    assert nat is not None
    ref = parse_text_numpy(text, "libsvm", 3, 1000, 1)
    np.testing.assert_array_equal(nat.feats, ref.feats)
    np.testing.assert_allclose(nat.vals, ref.vals, rtol=1e-6)
    np.testing.assert_array_equal(nat.y, ref.y)


def test_native_parser_truncation():
    from ftrl_ffm_tpu.data.parser import parse_text_native, parse_text_numpy

    text = "1 0:1:1 1:2:1 2:3:1 0:4:1 1:5:1\n"
    nat = parse_text_native(text, "libffm", 3, 1000, 3)
    assert nat is not None
    ref = parse_text_numpy(text, "libffm", 3, 1000, 3)
    np.testing.assert_array_equal(nat.feats, ref.feats)
    assert nat.nnz[0] == 5  # true nnz preserved pre-truncation


def test_stream_block_mode_no_trailing_newline(tmp_path):
    """Block-mode streaming (bytes -> C++ parser) handles files without a
    final newline and with blank lines."""
    from ftrl_ffm_tpu.data.stream import StreamReader

    p = tmp_path / "x.ffm"
    p.write_text("1 0:1:1.0 1:2:1.0\n\n0 0:3:1.0 1:4:1.0\n1 1:1:1.0 0:2:1.0")
    r = StreamReader(str(p), "libffm", 2, 2, 10, 4)
    batches = list(r.batches())
    total = sum(int(a[4].sum()) for a in batches)
    assert total == 3
    ys = np.concatenate([a[3][a[4] > 0] for a in batches])
    np.testing.assert_array_equal(ys, [1.0, 0.0, 1.0])


def test_stream_block_boundary_splits_line(tmp_path):
    """A line split across the block boundary is completed, not duplicated."""
    import ftrl_ffm_tpu.data.stream as st

    p = tmp_path / "y.ffm"
    lines = [f"{i % 2} 0:{i % 7}:1 1:{(i + 3) % 7}:1" for i in range(500)]
    p.write_text("\n".join(lines) + "\n")
    old = st.BLOCK_BYTES
    st.BLOCK_BYTES = 97  # force many mid-line block splits
    try:
        r = st.StreamReader(str(p), "libffm", 64, 2, 10, 4)
        total = sum(int(a[4].sum()) for a in r.batches())
    finally:
        st.BLOCK_BYTES = old
    assert total == 500


# ------------------------------------------- native compact-transfer encoding
def _mk_trainer(tmp_path, idx, model_type="FFM", n_feats=1000, n_fields=4):
    from ftrl_ffm_tpu.config import Config
    from ftrl_ffm_tpu.train import Trainer

    p = tmp_path / f"d{idx}.ffm"
    p.write_text("1 0:1:1 1:2:1 2:3:1 3:4:1\n")
    return Trainer(Config(
        train_data=str(p), model_type=model_type, n_feats=n_feats,
        n_fields=n_fields, n_factors=2, batch_size=8, max_nnz=5,
    ))


def _compact_scenarios(n_feats, n_fields, rng):
    """Batch sequences covering every encoding branch; sequences matter
    (the delta hysteresis is stateful)."""
    sent = n_feats
    f = 5

    def mk(b, ids=None, vals=None, sw=None, pad_rows=0, group=0, iota=False):
        if iota:  # canonical one-feature-per-field slot order
            fields = np.broadcast_to(
                np.arange(f, dtype=np.int32), (b, f)
            ).copy()
        else:
            fields = rng.integers(0, n_fields, (b, f)).astype(np.int32)
        if ids is None:
            # per-column clustered ids (the CTR shape delta relies on)
            base = rng.integers(0, max(1, n_feats - 300), f)
            ids = (base[None, :] + rng.integers(0, 200, (b, f))).astype(
                np.int32
            )
            ids = np.minimum(ids, n_feats - 1)
        if vals is None:
            vals = np.ones((b, f), np.float32)
        y = (rng.random(b) > 0.5).astype(np.float32)
        if sw is None:
            sw = np.ones(b, np.float32)
        if pad_rows:
            ids = ids.copy()
            vals = vals.copy()
            ids[-pad_rows:] = sent
            vals[-pad_rows:] = 0.0
            sw = sw.copy()
            sw[-pad_rows:] = 0.0
        arrs = (fields, ids, vals.astype(np.float32), y, sw)
        if group:
            arrs = tuple(np.stack([a] * group) for a in arrs)
        return arrs

    int_vals = rng.integers(-3, 6, (8, f)).astype(np.float32)
    bf16_vals = (rng.integers(1, 9, (8, f)) * 0.25).astype(np.float32)
    f32_vals = rng.random((8, f)).astype(np.float32) + 0.1
    wide = np.zeros((8, f), np.int32)
    wide[0, 0] = 0
    wide[1, 0] = min(n_feats - 1, 70000)
    return [
        [mk(8)],                                   # all-ones marker + delta
        [mk(8, pad_rows=3)],                       # padded tail: int8 vals
        [mk(8, vals=int_vals)],                    # int8 vals
        [mk(8, vals=bf16_vals)],                   # bf16 vals
        [mk(8, vals=f32_vals)],                    # f32 fallback
        [mk(8, ids=wide), mk(8)],                  # delta break + hysteresis
        [mk(8, sw=np.full(8, 0.5, np.float32))],   # fractional sample_w
        [mk(8, group=3)],                          # [S, B, F] scan group
        [mk(8, vals=bf16_vals, pad_rows=2), mk(8, vals=f32_vals), mk(8)],
        [mk(8, iota=True)],                        # fields-iota marker
        [mk(8, iota=True, pad_rows=2)],            # padded: marker refused
        [mk(8, iota=True, group=2)],               # iota marker in a group
    ]


def _assert_compact_equal(a, b, ctx):
    assert len(a) == len(b)
    for i, (x, z) in enumerate(zip(a, b)):
        assert (x is None) == (z is None), f"{ctx}[{i}] None mismatch"
        if x is None:
            continue
        assert x.dtype == z.dtype, f"{ctx}[{i}] dtype {x.dtype} != {z.dtype}"
        assert x.shape == z.shape, f"{ctx}[{i}] shape {x.shape} != {z.shape}"
        np.testing.assert_array_equal(
            np.asarray(x), np.asarray(z), err_msg=f"{ctx}[{i}]"
        )


@pytest.mark.parametrize("model_type,n_feats,n_fields", [
    ("FFM", 1000, 4),
    ("FFM", 100000, 39),
    ("FFM", 1000, 300),   # n_fields > 127: int16 fields (numpy cast path)
    ("FM", 1000, 4),
    ("LR", 100000, 4),
])
def test_native_compact_matches_numpy(tmp_path, monkeypatch, model_type,
                                      n_feats, n_fields):
    """ftrl_compact_batch must be byte-identical to the numpy _compact
    across every encoding branch."""
    import ftrl_ffm_tpu.native as native

    if native.lib() is None:
        pytest.skip("no native toolchain")

    rng = np.random.default_rng(17)
    scenarios = _compact_scenarios(n_feats, n_fields, rng)
    for s_idx, seq in enumerate(scenarios):
        t_nat = _mk_trainer(tmp_path, f"n{s_idx}", model_type, n_feats,
                            n_fields)
        t_np = _mk_trainer(tmp_path, f"p{s_idx}", model_type, n_feats,
                           n_fields)
        outs_nat = [t_nat._compact(arrs) for arrs in seq]
        with monkeypatch.context() as m:
            m.setattr(native, "compact_batch", lambda *a, **k: None)
            outs_np = [t_np._compact(arrs) for arrs in seq]
        assert t_nat._delta_ok == t_np._delta_ok, f"scenario {s_idx}"
        for b_idx, (a, b) in enumerate(zip(outs_nat, outs_np)):
            _assert_compact_equal(a, b, f"s{s_idx}b{b_idx}")


def test_native_compact_fuzz_random(tmp_path, monkeypatch):
    """Random-shape/content fuzz: native == numpy on arbitrary mixes of
    padding, value classes, and id spreads."""
    import ftrl_ffm_tpu.native as native

    if native.lib() is None:
        pytest.skip("no native toolchain")

    rng = np.random.default_rng(23)
    n_feats, n_fields = 80000, 12
    t_nat = _mk_trainer(tmp_path, "fz_n", "FFM", n_feats, n_fields)
    t_np = _mk_trainer(tmp_path, "fz_p", "FFM", n_feats, n_fields)
    for it in range(40):
        b = int(rng.integers(1, 33))
        f = int(rng.integers(1, 9))
        fields = rng.integers(0, n_fields, (b, f)).astype(np.int32)
        spread = int(rng.choice([100, 60000, 70000]))
        ids = rng.integers(0, spread, (b, f)).astype(np.int32)
        kind = int(rng.integers(0, 4))
        if kind == 0:
            vals = np.ones((b, f), np.float32)
        elif kind == 1:
            vals = rng.integers(-128, 128, (b, f)).astype(np.float32)
        elif kind == 2:
            vals = (rng.integers(0, 16, (b, f)) * 0.125).astype(np.float32)
        else:
            vals = rng.random((b, f)).astype(np.float32)
        if rng.random() < 0.4:  # padding occurrences / padded samples
            mask = rng.random((b, f)) < 0.3
            ids = np.where(mask, n_feats, ids)
            vals = np.where(mask, 0.0, vals).astype(np.float32)
        y = (rng.random(b) > 0.5).astype(np.float32)
        sw = (
            np.ones(b, np.float32)
            if rng.random() < 0.7
            else rng.random(b).astype(np.float32)
        )
        arrs = (fields, ids, vals, y, sw)
        out_nat = t_nat._compact(arrs)
        with monkeypatch.context() as m:
            m.setattr(native, "compact_batch", lambda *a, **k: None)
            out_np = t_np._compact(arrs)
        assert t_nat._delta_ok == t_np._delta_ok, f"iter {it}"
        _assert_compact_equal(out_nat, out_np, f"iter{it}")
