"""Shared test fixture: a small synthetic libffm/libsvm dataset written to a
temp file (the analogue of the reference's tests/common.h fixture, generated
rather than hard-coded)."""

from __future__ import annotations

import numpy as np

N_FIXTURE_LINES = 64
FIXTURE_FIELDS = 4
FIXTURE_FEATS = 40


def fixture_lines(file_type: str = "libffm", seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(N_FIXTURE_LINES):
        y = int(rng.random() < 0.5)
        toks = []
        for f in range(FIXTURE_FIELDS):
            feat = int(rng.integers(f * 10, (f + 1) * 10))
            val = round(float(rng.random() * 0.9 + 0.1), 4)
            if file_type == "libffm":
                toks.append(f"{f}:{feat}:{val}")
            else:
                toks.append(f"{feat}:{val}")
        lines.append(f"{y} " + " ".join(toks))
    return lines


def write_fixture(path, file_type: str = "libffm", seed: int = 0) -> str:
    text = "\n".join(fixture_lines(file_type, seed)) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def interpret_kernels(monkeypatch) -> None:
    """Run the GPU kernels in Pallas interpret mode on the CPU, and let
    use_pallas resolve to them as it does on a GPU."""
    import functools

    import ftrl_ffm_tpu.ops.ffm_pallas as fp

    for name in ("ffm_fused_logits_grads", "ffm_fused_logits"):
        monkeypatch.setattr(
            fp, name, functools.partial(getattr(fp, name), interpret=True)
        )
    monkeypatch.setattr(fp, "available", lambda: True)
