"""Recompute the ``roofline`` block of every dry-run JSON from its
``.ops.json.gz`` with the current ``roofline.hw`` constants, without
counting the step again (the reference's ``launch/reanalyze.py``).

  python -m repro_torch.launch.reanalyze results/dryrun
"""
import glob
import gzip
import json
import os
import sys

from repro_torch.roofline import analysis
from repro_torch.roofline.op_count import OpRecord


def reanalyze(json_path: str) -> dict:
    """The cell's JSON with its ``roofline`` recomputed from the op record
    beside it."""
    from repro_torch.launch.dryrun import cell_shape, configure
    with open(json_path) as f:
        d = json.load(f)
    with gzip.open(json_path.replace(".json", ".ops.json.gz"), "rt") as f:
        record = OpRecord.from_json(json.load(f))
    cfg = configure(d["arch"], d.get("overrides"))
    shape = cell_shape(cfg, d["shape"], d.get("shape_overrides"))
    d["roofline"] = analysis.from_counts(d["arch"], shape, d["mesh"],
                                         d["chips"], record, cfg).to_dict()
    return d


def main(out_dir: str):
    for jf in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        if jf.endswith(".trace.json"):
            continue
        with open(jf) as f:
            if not json.load(f).get("ok"):
                continue
        if not os.path.exists(jf.replace(".json", ".ops.json.gz")):
            print("no op record for", jf)
            continue
        d = reanalyze(jf)
        with open(jf, "w") as f:
            json.dump(d, f, indent=1, default=str)
        print("reanalyzed", jf)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun")
