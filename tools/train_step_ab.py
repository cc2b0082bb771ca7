"""Time the compressed training step of two checkouts in turns on one
card: phi3-mini-3.8b at full width cut to 8 layers, global batch 4 x 512
tokens, one NCCL rank, transport oneshot, seed 0 (``chip_smoke.py``'s
train cell). Each turn is its own process running
``repro_torch.launch.train.train(comm="qlc", steps=N)`` from one
checkout's ``src``; turns go other, this, this, other. Prints each turn's
calibrate ms, per-step ms and losses, and one JSON line (also written to
``--json PATH`` when given). ``--digest`` runs each turn with
deterministic algorithms and adds the sha256 of its final parameters'
bytes: equal digests show the two checkouts' steps bit-equal.

Run from the root of a checkout, with the other checkout's tree under a
directory that ``.gitignore`` lists:
    python3 tools/train_step_ab.py --other build/parent
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_run(steps: int, digest: bool = False):
    """In this process: the train cell through ``train`` (the ``src`` of
    the checkout under test is first on sys.path)."""
    import hashlib
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import data_parallel
    from repro_torch.launch.train import train
    from repro_torch.kernels import qlc_fused
    if not torch.cuda.is_available():
        sys.exit("train_step_ab: no CUDA device available")
    qlc_fused.build_kernels()
    if digest:
        torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), num_layers=8)
    with data_parallel("cuda"):
        res = train(cfg, comm="qlc", steps=steps, seq_len=512, global_batch=4,
                    device="cuda", transport="oneshot", seed=0)
    hist = res["history"]
    out = {"calibrate_ms": res["calibrate_s"] * 1e3,
           "step_ms": [h["dt"] * 1e3 for h in hist],
           "losses": [h["loss"] for h in hist],
           "ok": all(h["ok"] for h in hist)}
    if digest:
        from repro_torch.models.transformer import pytree_leaves
        h = hashlib.sha256()
        for p in pytree_leaves(res["params"]):
            h.update(p.detach().cpu().numpy().tobytes())
        out["sha256"] = h.hexdigest()
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other checkout's tree "
                    "(required unless --run)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--json", help="also write the result line here")
    ap.add_argument("--digest", action="store_true",
                    help="deterministic algorithms; print each turn's "
                    "parameter digest")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        sys.path.insert(0, os.path.join(args.run, "src"))
        one_run(args.steps, args.digest)
        return
    if not args.other:
        ap.error("--other is required")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[train-ab] {smi}", flush=True)
    turns = []
    for who, root in (("other", args.other), ("this", ROOT), ("this", ROOT),
                      ("other", args.other)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run",
             os.path.abspath(root), "--steps", str(args.steps)]
            + (["--digest"] if args.digest else []),
            capture_output=True, text=True, cwd=ROOT)
        if out.returncode != 0:
            sys.exit(f"train_step_ab: the {who} run failed:\n"
                     f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        r = json.loads(out.stdout.strip().splitlines()[-1])
        r["who"] = who
        turns.append(r)
        print(f"[train-ab] {who}: calibrate {r['calibrate_ms']:.1f} ms, steps "
              f"{[round(t, 3) for t in r['step_ms']]} ms, losses "
              f"{r['losses']}, ok {r['ok']}"
              + (f", sha256 {r['sha256']}" if args.digest else ""),
              flush=True)
    line = json.dumps({"device": smi, "turns": turns})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
