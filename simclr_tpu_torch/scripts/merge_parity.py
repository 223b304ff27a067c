"""Merge ``parity_run`` result fragments into one parity.json/parity.md.

Counterpart of ``scripts/merge_parity.py``, whose usage and output it
keeps byte for byte: ``parity_run`` rewrites its ``parity.json`` from
scratch, so runs resumed across invocations (seed 0 in one, seeds 1-3 in the
next) leave fragments. This merges them, keeps the later row of each
(variant, seed), and writes the per-run and seed-aggregated markdown
tables. It reads and writes files only, so it takes no ``--device``.

    python -m simclr_tpu_torch.scripts.merge_parity OUT_DIR FRAG.json ...
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

from simclr_tpu_torch.scripts.parity_run import run_rows, seed_rows


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("out_dir", help="directory for parity.json/parity.md")
    p.add_argument("fragments", nargs="+", help="parity.json fragments")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    out = Path(args.out_dir)
    seen = {}
    for frag in args.fragments:
        for r in json.loads(Path(frag).read_text()):
            seen[(r["variant"], r["seed"])] = r
    # Stable order: seed-major, then first appearance.
    order = {key: (key[1], i) for i, key in enumerate(seen)}
    rows = [seen[k] for k in sorted(seen, key=lambda k: order[k])]
    (out / "parity.json").write_text(json.dumps(rows, indent=2))

    real = rows[0].get("real_data", False)
    lines = [
        "# Accuracy-parity results",
        "",
        f"Data: {'real cifar10' if real else 'synthetic stand-in'}"
        " | merged fragments: " + ", ".join(args.fragments),
        "",
    ] + run_rows(rows) + [""] + seed_rows(rows)
    (out / "parity.md").write_text("\n".join(lines) + "\n")
    print(f"{len(rows)} rows -> {out}/parity.json, parity.md")


if __name__ == "__main__":
    main()
