"""Model serialization.

Two formats:

1. **Full checkpoints** (new capability): the entire optimizer state —
   bias/linear/factor (n, z) accumulator pairs plus the factor init table and
   step counter — zstd-compressed with a JSON header.  The reference only
   serializes weights, so a loaded reference model cannot faithfully resume
   training (SURVEY §5); full checkpoints can.

2. **Reference-compatible weight blobs**: a raw little-endian float32 array
   [bias, lin_w..., vec_w row-major...] zstd-compressed with no framing —
   byte-compatible with the reference's compress_weights / decompress_weights
   (reference: src/compression/compress.cpp:15-51, layout from
   src/model/ffm.cpp:138-159 and src/model/lr.cpp:26-39), so models can be
   exchanged with the C++ binary in both directions.  The FFM plain-text
   format (src/model/ffm.cpp:161-200) is also supported.
"""

from __future__ import annotations

import json
import os
import struct

import jax.numpy as jnp
import ml_dtypes  # registers bfloat16 with numpy for checkpoint round-trips
import numpy as np

from ftrl_ffm_tpu.io import zstd
from ftrl_ffm_tpu.models.base import ModelState

MAGIC = b"FTRLTPU1"


class IncompatibleStateError(ValueError):
    """A loaded checkpoint / imported model does not match the current
    model-defining config.

    The fail-loud analogue of the reference's CHECK/*_orDie file-op style
    (reference: src/compression/file_ops.h:23-37): a state restored under
    different --n_feats/--n_fields/--n_factors/--table_dtype would either
    die with an opaque XLA shape error or — worse, on a field_pad change —
    silently re-interpret factor-row lanes."""


# Config keys that define the model's table shapes and semantics.  field_pad
# and row_width are derived but persisted explicitly: the padding heuristic
# deciding lane layout must match bit-for-bit on resume, even if the
# heuristic itself changes between versions.
_SIG_KEYS = (
    "model_type",
    "n_feats",
    "n_fields",
    "n_factors",
    "table_dtype",
    "factor_semantics",
)


def model_signature(cfg) -> dict:
    """The model-defining subset of a Config, as stored in checkpoint
    headers and compared on every resume/import."""
    sig = {k: getattr(cfg, k) for k in _SIG_KEYS}
    sig["field_pad"] = cfg.field_pad
    sig["row_width"] = cfg.row_width
    return sig


def validate_header_compat(cfg, extra: dict, source: str) -> None:
    """Raise IncompatibleStateError if `extra` (a checkpoint header) records
    a model config that mismatches `cfg`.

    Headers written by Trainer.save_checkpoint carry "model_config"
    (model_signature); older headers carry only the CLI "config" dict —
    compare whatever model-defining keys are present.  Headers with
    neither (hand-built checkpoints) pass; the Trainer's structural shape
    validation still applies."""
    saved = (extra or {}).get("model_config")
    if saved is None:
        c = (extra or {}).get("config") or {}
        saved = {k: c[k] for k in _SIG_KEYS if k in c}
        if "model_type" in saved:  # Config.__post_init__ upper-cases
            saved["model_type"] = str(saved["model_type"]).upper()
    if not saved:
        return
    cur = model_signature(cfg)
    bad = {k: (saved[k], cur[k]) for k in saved if k in cur and saved[k] != cur[k]}
    if bad:
        detail = ", ".join(
            f"{k}: checkpoint has {a!r}, config has {b!r}"
            for k, (a, b) in sorted(bad.items())
        )
        raise IncompatibleStateError(
            f"{source} was saved under a different model config — {detail}. "
            f"Resume with the original flags, or retrain."
        )


# ---------------------------------------------------------------- checkpoints
_TABLES = ("lin_n", "lin_z", "lin_w", "vec_n", "vec_z", "vec_w")
CHUNK_BYTES = 64 << 20  # max host-resident bytes per table while streaming


def _chunk_rows(shape, itemsize) -> int:
    row_bytes = itemsize * (int(np.prod(shape[1:])) if len(shape) > 1 else 1)
    return max(1, CHUNK_BYTES // max(1, row_bytes))


def _logical_row_chunks(val, n_shards: int, n_feats: int):
    """Yield (logical_shape, chunk iterator) for one table.

    Sharded tables live in physical (modulo-interleaved, padded) row order
    across devices (parallel/mesh.py::interleave_ids); each chunk is gathered
    on device in logical id order and pulled to host one slab at a time — the
    coordinator never materializes a whole table (SURVEY §5: "sharded per
    host" checkpointing without a full-table host gather)."""
    arr_rows = val.shape[0]
    rows = min(n_feats, arr_rows) if n_shards > 1 else arr_rows
    shape = (rows,) + tuple(val.shape[1:])
    step = _chunk_rows(shape, np.dtype(str(val.dtype)).itemsize)

    def chunks():
        rl = arr_rows // n_shards
        for a in range(0, rows, step):
            b = min(rows, a + step)
            if n_shards == 1:
                yield np.asarray(val[a:b])
            else:
                ids = np.arange(a, b)
                phys = (ids % n_shards) * rl + ids // n_shards
                if isinstance(val, np.ndarray):
                    # host-snapshot path (async mid-training checkpoints):
                    # de-interleave in numpy, no device round-trip
                    yield val[phys]
                else:
                    yield np.asarray(jnp.take(val, jnp.asarray(phys), axis=0))

    return shape, chunks


def save_checkpoint(
    path: str,
    state: ModelState,
    level: int = 3,
    extra: dict | None = None,
    n_shards: int = 1,
    n_feats: int = 0,
):
    """Stream a full-state checkpoint to zstd.

    Accepts single-device states directly, or mesh-sharded states via
    (n_shards, n_feats): tables are then de-interleaved to logical row order
    chunk-by-chunk on device, so peak host memory is one CHUNK_BYTES slab —
    not one table.  The on-disk format is identical either way (checkpoints
    are mesh-independent; resume on any mesh re-shards on load)."""
    meta = {"fields": [], "extra": extra or {}}
    writers = []
    for name, val in state._asdict().items():
        if val is None:
            meta["fields"].append({"name": name, "none": True})
            continue
        if name in _TABLES and val.ndim >= 1 and n_shards >= 1:
            shape, chunks = _logical_row_chunks(val, n_shards, n_feats or val.shape[0])
        else:
            arr = np.asarray(val)
            shape, chunks = arr.shape, (lambda a=arr: iter((a,)))
        meta["fields"].append(
            {"name": name, "dtype": str(np.dtype(str(val.dtype))), "shape": list(shape)}
        )
        writers.append(chunks)

    header = json.dumps(meta).encode()
    # crash-atomic: compress into a sibling temp file, fsync, then rename —
    # a crash mid-write leaves the previous checkpoint intact (at worst a
    # stray .tmp file), never a truncated checkpoint at `path`
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            with zstd.Writer(f, level) as zf:
                zf.write(MAGIC + struct.pack("<I", len(header)) + header)
                for chunks in writers:
                    for chunk in chunks():
                        zf.write(np.ascontiguousarray(chunk))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_checkpoint(path: str) -> tuple[ModelState, dict]:
    """Stream-read a checkpoint: each table decompresses directly into its
    preallocated buffer (no whole-file decompressed copy)."""
    with open(path, "rb") as f, zstd.Reader(f) as zf:
        head = zf.read(12)
        if head[:8] != MAGIC:
            raise ValueError(f"{path}: not a ftrl_ffm_tpu checkpoint")
        hlen = struct.unpack("<I", head[8:12])[0]
        meta = json.loads(zf.read(hlen))
        kwargs = {}
        for fld in meta["fields"]:
            if fld.get("none"):
                kwargs[fld["name"]] = None
                continue
            dt = np.dtype(fld["dtype"])
            arr = np.empty(tuple(fld["shape"]), dtype=dt)
            view = arr.reshape(-1).view(np.uint8)
            got = zf.readinto(view)
            while got < view.nbytes:
                n = zf.readinto(view[got:])
                if not n:
                    raise ValueError(f"{path}: truncated checkpoint")
                got += n
            # host numpy, not device arrays: the caller (Trainer init /
            # shard_state) decides placement — an eager device put here
            # wastes a full HBM round-trip on sharded resume and doubles
            # peak device-0 memory at 1M-row scale
            kwargs[fld["name"]] = arr
    return ModelState(**kwargs), meta["extra"]


# ------------------------------------------- reference-compatible weight blob
def export_reference_model(path: str, bias, lin_w, vec_w=None, level: int = 3):
    """Write [bias, lin_w..., vec_w...] float32, zstd, no framing — readable by
    the reference's load_compressed_model."""
    parts = [np.array([bias], "<f4"), np.asarray(lin_w, "<f4").ravel()]
    if vec_w is not None:
        parts.append(np.asarray(vec_w, "<f4").ravel())
    raw = np.concatenate(parts).tobytes()
    with open(path, "wb") as f:
        f.write(zstd.compress(raw, level))
    import sys

    # stderr: stdout may be carrying the --predict_output - probability
    # stream (cli.py's one-probability-per-line contract)
    print(f"compress file size: {len(raw)} -> {os_size(path)}", file=sys.stderr)


def os_size(path: str) -> int:
    import os

    return os.path.getsize(path)


def import_reference_model(path: str, n_feats: int, row_width: int = 0):
    """Read a reference compressed model -> (bias, lin_w[, vec_w]).

    The blob is unframed (raw [bias, lin_w..., vec_w...] floats,
    reference: src/model/ffm.cpp:138-159), so the ONLY consistency check
    possible is the exact float count — enforced here: a silent slice of a
    mismatched blob would scramble every weight past the first table."""
    with open(path, "rb") as f:
        raw = zstd.decompress(f.read())
    flat = np.frombuffer(raw, "<f4")
    expect = 1 + n_feats + n_feats * row_width
    if flat.size != expect:
        raise IncompatibleStateError(
            f"{path}: reference model blob holds {flat.size} floats, but "
            f"the config (n_feats={n_feats}, factor row width {row_width}) "
            f"expects exactly {expect} (1 bias + n_feats linear"
            + (f" + n_feats*{row_width} factors" if row_width else "")
            + ") — wrong --n_feats/--n_fields/--n_factors/--model_type for "
            "this blob?"
        )
    bias = float(flat[0])
    lin_w = flat[1 : 1 + n_feats].copy()
    vec_w = None
    if row_width:
        vec_w = flat[1 + n_feats : 1 + n_feats + n_feats * row_width].reshape(
            n_feats, row_width
        ).copy()
    return bias, lin_w, vec_w


# --------------------------------------------------- FFM plain-text format
def export_reference_text_model(path: str, bias, lin_w, vec_w):
    """FFM text layout: bias line, one lin_w per line, one factor row per line
    (reference: src/model/ffm.cpp:161-177)."""
    with open(path, "w") as f:
        f.write(f"{float(bias)}\n")
        for w in np.asarray(lin_w).ravel():
            f.write(f"{float(w)}\n")
        for row in np.asarray(vec_w):
            f.write(" ".join(str(float(x)) for x in row) + "\n")


def import_reference_text_model(path: str, n_feats: int, row_width: int):
    """Read the FFM plain-text layout (reference: src/model/ffm.cpp:179-200).

    Validated like the blob import: line counts and factor-row widths must
    match the config exactly, with a named error instead of float('')."""
    with open(path, "r") as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    expect = 1 + 2 * n_feats
    if len(lines) != expect:
        raise IncompatibleStateError(
            f"{path}: FFM text model has {len(lines)} lines, but the config "
            f"(n_feats={n_feats}) expects exactly {expect} "
            f"(1 bias + n_feats linear + n_feats factor rows)"
        )
    try:
        bias = float(lines[0])
        lin_w = np.array(lines[1 : 1 + n_feats], np.float32)
        rows = [
            np.array(row.split(), np.float32) for row in lines[1 + n_feats :]
        ]
        widths = {r.shape[0] for r in rows}
        if len(widths) > 1:
            raise IncompatibleStateError(
                f"{path}: ragged factor rows (widths {sorted(widths)})"
            )
        vec_w = np.stack(rows)
    except IncompatibleStateError:
        raise
    except ValueError as e:
        raise IncompatibleStateError(f"{path}: malformed number: {e}") from e
    if vec_w.shape[-1] != row_width:
        # exact match only: a wider import would otherwise silently drop
        # factor lanes (e.g. a k=8 model warm-started under k=4) — the
        # same misinterpretation class the checkpoint header validation
        # exists to make loud
        raise IncompatibleStateError(
            f"{path}: factor rows have {vec_w.shape[-1]} values, but the "
            f"config (n_fields * n_factors) expects exactly {row_width}"
        )
    return bias, lin_w, vec_w
