"""Paired ATE gaps between runs of tests/torch_seed_sweep.py.

Each ``NAME=LOG[,LOG...]`` gathers, from the per-seed lines of its logs
(one side each), the ATE and the final z error (the last frame's estimated
minus true z) of every seed, as the sweep prints them (to 0.1 mm and 1
mm). For each NAME it prints the seed count, the ATE mean and standard
deviation (ddof 1) and the mean final z error; for each ``--pair A:B``
the paired gap A - B over the seeds both have, its standard error (the
differences' standard deviation, ddof 1, over the square root of their
count) and the gap in standard errors. Ends with
one JSON line of the same numbers. For example, on the logs of two sweeps
(``--side torch`` and ``--side jax --jax-fused``, the latter in two parts):

    python tests/torch_pair_gaps.py port=torch_k1.log \\
        jax_pallas=jax_fused_a.log,jax_fused_b.log --pair port:jax_pallas
"""

import argparse
import json
import re

import numpy as np


LINE = re.compile(r"^(\w+) seed (\d+): ATE ([0-9.]+) m, .*last error xyz \[([^\]]+)\]")


def read_side(paths):
    """{seed: (ATE, final z error)} from the per-seed lines of ``paths``
    (one side a log)."""
    out, sides = {}, set()
    for path in paths:
        with open(path) as fh:
            for line in fh:
                m = LINE.match(line)
                if m:
                    sides.add(m.group(1))
                    out[int(m.group(2))] = (float(m.group(3)), float(m.group(4).split(",")[2]))
    if len(sides) > 1:
        raise SystemExit(f"{paths}: lines of sides {sorted(sides)}; give one side a NAME")
    return out


def summary(runs, pairs):
    res = {"sides": {}, "pairs": {}}
    for name, by_seed in runs.items():
        ate = np.array([a for a, _ in by_seed.values()])
        z = np.array([z for _, z in by_seed.values()])
        res["sides"][name] = {"n": len(ate), "seeds": sorted(by_seed), "ate_mean_m": float(ate.mean()),
                              "ate_std_m": float(ate.std(ddof=1)) if len(ate) > 1 else 0.0,
                              "final_z_error_mean_m": float(z.mean()),
                              "final_z_error_std_m": float(z.std(ddof=1)) if len(z) > 1 else 0.0}
    for a, b in pairs:
        seeds = sorted(set(runs[a]) & set(runs[b]))
        d = np.array([runs[a][s][0] - runs[b][s][0] for s in seeds])
        se = float(d.std(ddof=1) / np.sqrt(len(d))) if len(d) > 1 else float("nan")
        res["pairs"][f"{a}-{b}"] = {"n": len(d), "gap_m": float(d.mean()), "se_m": se,
                                     "gap_in_se": float(d.mean() / se) if se > 0 else float("nan")}
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+", metavar="NAME=LOG[,LOG...]")
    ap.add_argument("--pair", action="append", default=[], metavar="A:B")
    args = ap.parse_args()
    runs = {}
    for spec in args.runs:
        name, _, logs = spec.partition("=")
        runs[name] = read_side(logs.split(","))
    res = summary(runs, [p.split(":") for p in args.pair])
    for name, s in res["sides"].items():
        print(f"{name}: n {s['n']}, ATE {s['ate_mean_m']:.4f} +- {s['ate_std_m']:.4f} m, "
              f"final z error {s['final_z_error_mean_m']:+.3f} +- {s['final_z_error_std_m']:.3f} m")
    for name, p in res["pairs"].items():
        print(f"{name}: n {p['n']}, gap {p['gap_m']:+.4f} +- {p['se_m']:.4f} m "
              f"({p['gap_in_se']:+.2f} SE)")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
