#!/usr/bin/env python3
"""Readings behind the caps of the card's step tests (`WITNESS_CAP` in
`tests/test_torch_port_gpu.py`).

Each of the four step tests holds the card's gradients to a float64 CPU
witness of the step on the card's own ids, within 5× the larger of the two
CPU float32 steps' distances from their witnesses (oneDNN's convolutions
and PyTorch's native ones), never above a fixed cap. This tool reads those
two CPU distances for each test's data at several seeds (seed 0 is the
test's own) and sets each cap to 10× the largest: twice the largest limit
that any seed gives. It runs on the CPU only:

    python3 tools/witness_caps.py [--seeds 0,1,2]

One JSON line per (test, seed), then a summary line with the caps.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import test_torch_port_gpu as gpu  # noqa: E402

CASES = {"second_stage": gpu._second_stage_case, "joint": gpu._joint_case,
         "vqgan": gpu._vqgan_case, "first_stage": gpu._first_stage_case}
FACTOR = 10


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", default="0,1,2")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    top = {}
    for test, make in CASES.items():
        for seed in seeds:
            gaps = gpu.cpu_witness_gaps(make(seed))
            print(json.dumps({"test": test, "seed": seed, "grad_rel_err_vs_f64": gaps}),
                  flush=True)
            for m in gaps["cpu"]:
                seen = max(gaps["cpu"][m], gaps["cpu_native"][m])
                top.setdefault(test, {})[m] = max(top.get(test, {}).get(m, 0.0), seen)
    print(json.dumps({"seeds": seeds, "largest": top, "factor": FACTOR,
                      "caps": {t: {m: FACTOR * v for m, v in d.items()}
                               for t, d in top.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
