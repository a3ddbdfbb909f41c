"""Time granite_moe_3b's serving steps under both MoE dispatch engines
with the functions of one tree's own ``chip_smoke.py`` (phase 13's
``init_lm`` and ``time_steps``: bf16, full width and depth, seed 0's
weights, the first of ``LM_BATCHES``), so that two trees of the repo are
compared on one card in one call:

    python3 tools/time_moe_decode.py TREE [--repeats N]

``TREE`` is the root of a checkout (its ``chip_smoke.py`` and ``src/``
are imported, nothing of this tree's).  Run it for each tree in turn,
for example parent, change, change, parent.  One warm-up pass per
engine, then ``N`` timed passes; prints the card's name and power limit
and one JSON line per pass: prefill ms and decode ms a step.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    assert Path(cs.__file__).resolve().parent == tree, cs.__file__
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cs.build_all()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.get_config(cs.MOE_ARCH)
    params, _ = cs.init_lm(cfg, dev)
    batch, plen, new = cs.LM_BATCHES[0]
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, plen), dtype=np.int32)).to(dev)
    for rep in range(-1, args.repeats):
        for impl in ("dense", "sorted"):
            ecfg = dataclasses.replace(cfg, moe_impl=impl)
            steps = cs.time_steps(ecfg, params, prompts, new, dev)
            if rep >= 0:
                print(json.dumps({
                    "tree": tree.name, "impl": impl, "pass": rep,
                    "shape": f"{batch} x {plen} + {new}",
                    "prefill_ms": steps["prefill_ms"],
                    "decode_ms_per_step": steps["decode_ms_per_step"]}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
