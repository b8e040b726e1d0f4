"""Render the dry-run JSON (``launch/dryrun.py``) into the roofline tables:
the JAX package's ``repro.launch.report``, character for character.

    PYTHONPATH=src python -m repro_torch.launch.report [build/dryrun_results.json]
"""
from __future__ import annotations

import json
import sys


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def render_table(path: str, mesh: str = "16x16") -> str:
    data = _load(path)
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "MODEL_FLOPS | useful/HLO | roofline frac | peak GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for k in sorted(data):
        v = data[k]
        if "error" in v:
            if v.get("mesh", mesh) == mesh:
                lines.append(f"| {v['arch']} | {v['shape']} | ERROR: {v['error'][:60]} |")
            continue
        if v["mesh"] != mesh:
            continue
        rf = v["roofline"]
        peak = v.get("memory", {}).get("peak_per_device", 0) / 2**30
        lines.append(
            f"| {v['arch']} | {v['shape']} | {rf['compute_s']:.3g} | "
            f"{rf['memory_s']:.3g} | {rf['collective_s']:.3g} | "
            f"{rf['dominant'].replace('_s','')} | {v['model_flops']:.3g} | "
            f"{rf.get('useful_flop_ratio', 0):.3f} | "
            f"{rf.get('roofline_fraction', 0)*100:.2f}% | {peak:.1f} |"
        )
    return "\n".join(lines)


def render_multipod_check(path: str) -> str:
    data = _load(path)
    ok = sum(1 for v in data.values() if "error" not in v and v["mesh"] == "2x16x16")
    tot = sum(1 for v in data.values() if v.get("mesh") == "2x16x16")
    rows = []
    for k in sorted(data):
        v = data[k]
        if v.get("mesh") != "2x16x16" or "error" in v:
            continue
        peak = v.get("memory", {}).get("peak_per_device", 0) / 2**30
        rows.append(
            f"| {v['arch']} | {v['shape']} | {v['compile_s']}s | {peak:.1f} |"
        )
    header = (
        f"Multi-pod (2x16x16 = 512 chips): **{ok}/{tot} cells lower+compile OK**\n\n"
        "| arch | shape | compile | peak GiB/dev |\n|---|---|---|---|\n"
    )
    return header + "\n".join(rows)


if __name__ == "__main__":
    print(render_table(sys.argv[1] if len(sys.argv) > 1 else "build/dryrun_results.json"))
