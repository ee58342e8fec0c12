"""Bytes-moved roofline model for one FTRL train step.

Prints the per-pass device-memory traffic of the current step design and
the implied step-time floor at the device's published bandwidth
(tools/peaks.py), so a measured step can be judged against physics (step
design: ftrl.py module docstring + ops/ffm_pallas.py).

Usage:
    python tools/roofline.py [--batch 16384] [--nnz 39] [--n_fields 39]
        [--n_factors 16] [--n_feats 100000] [--model FFM]
        [--update dense2|inplace|sparse2]
        [--device "NVIDIA H100 80GB HBM3"] [--measured_ms 0]

The model (f32 tables; nnz = occurrences per step = batch * nnz_per_sample):
  v-row gather      read E-wide rows per occurrence + write [nnz, E]
  fused kernel      read [nnz, E] + write [nnz, 2E] combined (g || g^2)
  combined scatter  read payload + zero-init [R, 2E] acc + RMW touched rows
  closed-form pass  read acc + (n, z, w) tables, write (n, z, w)
  linear path       same chain at row width 1 (counted, ~1% of total)
Touched-row RMW is costed at unique-row granularity with
E[unique] = R * (1 - exp(-nnz / R)) for uniformly drawn ids (an upper bound
for skewed CTR ids, which collide more).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from peaks import peaks  # noqa: E402


def unique_rows(n_rows: int, nnz: int) -> float:
    """Expected distinct rows touched by nnz uniform draws from n_rows."""
    if n_rows <= 0:
        return 0.0
    return n_rows * (1.0 - math.exp(-nnz / n_rows))


def step_bytes(
    batch: int,
    nnz_per_sample: int,
    n_fields: int,
    n_factors: int,
    n_feats: int,
    model: str = "FFM",
    update: str = "dense2",
    dtype_bytes: int = 4,
) -> dict[str, float]:
    """Per-pass HBM bytes for one train step of the current design."""
    nnz = batch * nnz_per_sample
    if model == "LR":
        e = 0
    elif model == "FM":
        e = n_factors
    else:
        e = n_fields * n_factors
    r = n_feats
    u = unique_rows(r, nnz)
    b = dtype_bytes
    passes: dict[str, float] = {}

    def table_update(width: int, tag: str) -> None:
        """dense2: payload read + acc init + RMW + closed-form pass."""
        if update == "dense2":
            passes[f"{tag} scatter (payload read + acc init + RMW)"] = (
                nnz * 2 * width * b + r * 2 * width * b + 2 * u * 2 * width * b
            )
            passes[f"{tag} closed-form (acc + n,z,w in; n,z,w out)"] = (
                r * 2 * width * b + 6 * r * width * b
            )
        elif update == "inplace":
            # g scattered straight into z; one [R, width] g^2 accumulator
            passes[f"{tag} scatter (payload read + z/acc RMW + acc init)"] = (
                nnz * 2 * width * b + 4 * u * width * b + r * width * b
            )
            passes[f"{tag} closed-form (n,z,acc,w in; n,z,w out)"] = (
                7 * r * width * b
            )
        else:  # sparse2: sort + segment + touched-row gather/scatter
            passes[f"{tag} sort/segment (id sort + payload reorder)"] = (
                nnz * 4 * 4 + 2 * nnz * 2 * width * b + nnz * 2 * width * b
            )
            passes[f"{tag} touched rows (gather n,z,w + scatter back)"] = (
                6 * u * width * b
            )

    if e:
        passes["v-row gather (rows in, [nnz,E] out)"] = 2 * nnz * e * b
        passes["fused kernel ([nnz,E] in, [nnz,2E] out)"] = (
            nnz * e * b + nnz * 2 * e * b
        )
        table_update(e, "factor")
    # linear table: same chain at width 1 (w gather rides with the forward)
    passes["linear path (gather + scatter + closed form)"] = (
        2 * nnz * b + (nnz * 2 + r * 2 + 4 * u + 8 * r) * b
    )
    return passes


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--nnz", type=int, default=0, help="nnz per sample (default n_fields)")
    ap.add_argument("--n_fields", type=int, default=39)
    ap.add_argument("--n_factors", type=int, default=16)
    ap.add_argument("--n_feats", type=int, default=100_000)
    ap.add_argument("--model", default="FFM", choices=["LR", "FM", "FFM"])
    ap.add_argument("--update", default="dense2", choices=["dense2", "inplace", "sparse2"])
    ap.add_argument("--device", default="NVIDIA H100 80GB HBM3",
                    help="JAX device_kind whose published peaks to use")
    ap.add_argument("--measured_ms", type=float, default=0.0)
    args = ap.parse_args()

    nnz_ps = args.nnz or args.n_fields
    passes = step_bytes(
        args.batch, nnz_ps, args.n_fields, args.n_factors, args.n_feats,
        args.model, args.update,
    )
    total = sum(passes.values())
    print(
        f"{args.model} B={args.batch} nnz/sample={nnz_ps} C={args.n_fields} "
        f"K={args.n_factors} R={args.n_feats} update={args.update}"
    )
    for name, byts in passes.items():
        print(f"  {name:58s} {byts / 1e9:7.3f} GB")
    hbm = peaks(args.device)["hbm_bytes_per_s"]
    floor_ms = total / hbm * 1e3
    print(f"  {'TOTAL':58s} {total / 1e9:7.3f} GB")
    print(
        f"floor @ {hbm / 1e9:.0f} GB/s ({args.device}): {floor_ms:.2f} ms/step "
        f"= {args.batch / floor_ms * 1e3:,.0f} ex/s"
    )
    if args.measured_ms:
        print(
            f"measured {args.measured_ms:.2f} ms -> "
            f"{floor_ms / args.measured_ms * 100:.0f}% of roofline"
        )


if __name__ == "__main__":
    main()
