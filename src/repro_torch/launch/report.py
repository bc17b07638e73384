"""Render the dry run's roofline table and its perf comparisons from
results/dryrun_torch/*.json: the port of the JAX package's
``launch/report.py``.

    python -m repro_torch.launch.report            # print tables
    python -m repro_torch.launch.report --inject   # splice into EXPERIMENTS.md

The repository has no EXPERIMENTS.md, so ``--inject`` prints, as the JAX
package's does without the file.
"""
from __future__ import annotations

import argparse
import json
import pathlib

__all__ = ["RESULTS", "roofline_markdown", "perf_markdown", "main"]

RESULTS = pathlib.Path("results/dryrun_torch")
EXP = pathlib.Path("EXPERIMENTS.md")


def _fmt(v, n=3):
    return f"{v:.{n}f}" if isinstance(v, (int, float)) else str(v)


def roofline_markdown() -> str:
    rows = ["| arch | shape | mesh | compute s | memory s | coll s | "
            "bottleneck | useful | frac | mem GiB/dev | note |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for p in sorted(RESULTS.glob("*.json")):
        if p.stem.count("_") > 2 and not p.stem.endswith(("single", "multi")):
            continue  # tagged perf variants: the perf table
        r = json.loads(p.read_text())
        if r.get("skipped"):
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — "
                        "| — | — | — | — | — | SKIP: sub-quadratic-only |")
            continue
        if r.get("error"):
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                        "| — | — | — | — | — | — | — "
                        f"| ERROR: {r['error'][:60]} |")
            continue
        t = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {_fmt(t['compute_s'], 4)} | {_fmt(t['memory_s'], 4)} "
            f"| {_fmt(t['collective_s'], 4)} | {t['bottleneck']} "
            f"| {_fmt(t['useful_flops_ratio'], 2)} "
            f"| {_fmt(t['roofline_fraction'], 3)} "
            f"| {r['memory']['peak_est_bytes'] / 2**30:.1f} | |")
    return "\n".join(rows)


def perf_markdown() -> str:
    groups: dict[str, list] = {}
    for p in sorted(RESULTS.glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("skipped") or r.get("error") or "roofline" not in r:
            continue
        key = f"{r['arch']}:{r['shape']}:{r['mesh']}"
        tag = p.stem.replace(
            f"{r['arch']}_{r['shape']}_{r['mesh']}", "").lstrip("_") or "baseline"
        groups.setdefault(key, []).append((tag, r))
    rows = ["| cell | variant | compute s | memory s | coll s | bottleneck "
            "| frac | mem GiB | Δfrac |", "|---|---|---|---|---|---|---|---|---|"]
    for key, variants in groups.items():
        if len(variants) < 2:
            continue
        base = dict(variants)["baseline"]["roofline"]["roofline_fraction"] \
            if "baseline" in dict(variants) else None
        for tag, r in sorted(variants, key=lambda kv: kv[0] != "baseline"):
            t = r["roofline"]
            delta = ("—" if base is None or tag == "baseline"
                     else f"{t['roofline_fraction'] / base:.2f}×")
            rows.append(
                f"| {key} | {tag} | {_fmt(t['compute_s'], 3)} "
                f"| {_fmt(t['memory_s'], 3)} | {_fmt(t['collective_s'], 3)} "
                f"| {t['bottleneck']} | {_fmt(t['roofline_fraction'], 3)} "
                f"| {r['memory']['peak_est_bytes'] / 2**30:.1f} | {delta} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inject", action="store_true")
    args = ap.parse_args(argv)
    roof = roofline_markdown()
    perf = perf_markdown()
    if args.inject and EXP.exists():
        txt = EXP.read_text()
        txt = txt.replace("<!-- ROOFLINE_TABLE -->",
                          "<!-- ROOFLINE_TABLE -->\n\n" + roof, 1) \
            if "<!-- ROOFLINE_TABLE -->\n\n|" not in txt else txt
        txt = txt.replace("<!-- PERF_LOG -->",
                          "<!-- PERF_LOG -->\n\n" + perf, 1) \
            if "<!-- PERF_LOG -->\n\n|" not in txt else txt
        EXP.write_text(txt)
        print("injected into EXPERIMENTS.md")
    else:
        print(roof)
        print()
        print(perf)


if __name__ == "__main__":
    main()
