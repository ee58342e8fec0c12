"""Analytic multi-device scaling floor for the sharded FTRL step.

The sharded step's per-device bytes and collective volumes are exactly
computable from its communication structure (parallel/sharded.py).  This
tool prints, per mesh shape, the step-time floor those bytes imply at a
device's published peaks (tools/peaks.py: device memory for the local
legs, one direction of the card-to-card link for the collectives) and the
weak-scaling efficiency of that floor.  It is a bound, not a prediction of
measured time; a run on the cards says how close the step comes.

Conclusion it encodes: scale with a (1, N) route mesh — batch AND tables
sharded over all N devices, lookups/payloads routed by all_to_all.  Every
per-device leg is then either occurrence-proportional (constant under weak
scaling) or O(R/N) (shrinks with the mesh), and there is NO O(R)-sized
collective.  A hybrid (D, M) mesh with D > 1 keeps each table shard
replicated D ways and must all-reduce a [R/M, 2E] dense accumulator over
"data" every step — an O(R/M) link leg that dominates at production table
sizes.  D > 1 is only sensible while tables are small.

Per-device legs (weak scaling: per-DEVICE batch b_dev fixed):

  gather    occ rows x E f32 from the local shard, written [occ, E]
  a2a       routed id slots + [occ, E] rows there + [occ, 2E] payloads back
            over "model" (route) — volume is mesh-size-INDEPENDENT
  kernel    fused FFM pass: [occ, E] in, [occ, 2E] out
  scatter   [occ, 2E] payload into the [R/M, 2E] local accumulator
  psum_acc  (D > 1 only) all-reduce of the [R/M, 2E] accumulator over data
  pass      closed-form over the [R/M] shard (7 table-width passes)

Usage: python tools/scaling_model.py [--b_dev 2048] [--c 39] [--k 16]
         [--r 100000000] [--device "NVIDIA H100 80GB HBM3"]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from peaks import peaks  # noqa: E402


def model_step(d: int, m: int, b_dev: int, c: int, k: int, r: int,
               link_gbps: float, hbm_gbps: float = 3350.0) -> dict:
    """Floor of one sharded step on a (d, m) mesh: every local leg at
    `hbm_gbps` of device memory, every collective at `link_gbps` of link."""
    step = 128 // math.gcd(k, 128)
    cp = -(-c // step) * step
    e = cp * k                      # padded row width (floats)
    occ = b_dev * c                 # occurrences per device
    f4 = 4
    r_loc = r / m                   # rows per model shard
    hbm = hbm_gbps * 1e9
    link = link_gbps * 1e9

    t_gather = 2 * occ * e * f4 / hbm
    t_kernel = occ * (3 * e) * f4 / hbm
    # a2a over "model": ids there, [occ, E] rows back, [occ, 2E] payloads
    # there (unique-id routing: duplicates collapse; model the worst case)
    t_a2a = ((m - 1) / m) * occ * (3 * e) * f4 / link if m > 1 else 0.0
    t_scatter = (occ * 2 * e * f4 + r_loc * 2 * e * f4) / hbm
    t_psum_acc = (
        2 * (d - 1) / d * r_loc * 2 * e * f4 / link if d > 1 else 0.0
    )
    t_pass = r_loc * 7 * e * f4 / hbm
    total = t_gather + t_kernel + t_a2a + t_scatter + t_psum_acc + t_pass
    return {
        "total_ms": total * 1e3,
        "a2a_ms": t_a2a * 1e3,
        "psum_acc_ms": t_psum_acc * 1e3,
        "r_legs_ms": (t_pass + r_loc * 2 * e * f4 / hbm) * 1e3,
        "throughput": b_dev * d * m / total,
    }


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--b_dev", type=int, default=2048,
                   help="per-device batch (weak scaling constant)")
    p.add_argument("--c", type=int, default=39)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--r", type=int, default=100_000_000)
    p.add_argument("--device", default="NVIDIA H100 80GB HBM3",
                   help="JAX device_kind whose published peaks to use")
    a = p.parse_args()
    pk = peaks(a.device)
    link, hbm = pk["link_bytes_per_s"] / 1e9, pk["hbm_bytes_per_s"] / 1e9

    print(
        f"weak-scaling floor @ b_dev={a.b_dev}, C={a.c}, K={a.k}, R={a.r:,}, "
        f"{a.device}: HBM {hbm:.0f} GB/s, link {link:.0f} GB/s each way"
    )
    print(f"{'mesh':>10} {'chips':>6} {'step ms':>9} {'Mex/s':>7} "
          f"{'a2a ms':>7} {'psum ms':>8} {'eff':>7}")
    base = None
    shapes = [(1, 1), (1, 2), (1, 4), (1, 8), (1, 16), (1, 64), (1, 256),
              (2, 2), (4, 4), (8, 8)]
    for d, m in shapes:
        r_ = model_step(d, m, a.b_dev, a.c, a.k, a.r, link, hbm)
        n = d * m
        per_chip = r_["throughput"] / n
        if base is None:
            base = per_chip
        print(
            f"{f'({d},{m})':>10} {n:>6} {r_['total_ms']:9.1f} "
            f"{r_['throughput'] / 1e6:7.2f} {r_['a2a_ms']:7.1f} "
            f"{r_['psum_acc_ms']:8.1f} {per_chip / base:7.1%}"
        )
    print(
        "\nConclusion: (1, N) route meshes scale superlinearly per device "
        "at first (the O(R/N) table legs shrink), then settle at the "
        "a2a-vs-local ratio; (D, M) hybrids with D > 1 pay an O(R/M) "
        "accumulator all-reduce per step and should only be used while "
        "tables are small."
    )


if __name__ == "__main__":
    main()
