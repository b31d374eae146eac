#!/usr/bin/env python3
"""Spread of the gaps that `chip_smoke.py`'s vqgan (b) run holds to
`VQGAN_RESUME_GAP_LIMIT`.

The vqgan phase's (b) part trains `configs/crc_vqgan.json` through
`run_vqwnet.main -v` twice (run A: 6 steps; run B: 3 steps, then a resume
to 6) and holds B's final state to A's within `VQGAN_RESUME_GAP_LIMIT`:
the card's f32 weight gradients are not reproducible run to run, so the
resume is not held to 0. Two planted faulty resumes must land above the
limits: the codebook's EMA buffers dropped (above the limits as a whole),
the discriminator's Adam moments dropped (above the discriminator's).
The limits depend on the run's image size; this tool measures the
resume's gaps and the planted faults' at one size over several seeds, to
set them from a spread.

For each seed it runs the part as the phase runs it (`chip_smoke.
vqgan_run_part`, packed route, MEDIMG_CONV_PRECISION=ieee) with the
shipped limits and prints its record's gaps as one JSON line (a seed whose
gaps miss the shipped limits is reported, not fatal). The last line sums
up, for each limit key: the largest resume gap over the seeds, 5× it, the
smallest gap of each planted fault, and the shipped limit.

    python3 tools/vqgan_resume_spread.py [--size 256] [--seeds 0,1,2]

Needs one CUDA card; run from the repository's root.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=smoke.VQGAN_RUN_SIZE)
    parser.add_argument("--seeds", default="0,1,2")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("vqgan_resume_spread: no CUDA device", file=sys.stderr)
        return 1
    info = smoke.device_phase()
    smoke.build_phase(["vq_fused"])
    records, emitted = [], []
    smoke.emit = lambda obj: (emitted.append(obj), print(json.dumps(obj), flush=True))
    for seed in (int(s) for s in args.seeds.split(",")):
        emitted.clear()
        with smoke.conv_route("packed"), tempfile.TemporaryDirectory() as tmp:
            try:
                smoke.vqgan_run_part("cuda", tmp, None, size=args.size, patients=2,
                                     slices=20, seed=seed)
                held = True
            except RuntimeError as e:
                if not str(e).startswith("VQGAN run:"):
                    raise
                held = False
        rec = next(r for r in emitted if r.get("part") == "run")
        records.append(rec)
        print(json.dumps({"seed": seed, "size": args.size, "held_by_shipped_limits": held,
                          "resume_gap": rec["resume_gap"],
                          "planted_fault_gap": rec["planted_fault_gap"],
                          "planted_dis_fault_gap": rec["planted_dis_fault_gap"],
                          "fit_step_s_median": rec["fit_step_s_median"],
                          "path_s": rec["path_s"]}), flush=True)
        torch.cuda.empty_cache()
    summary = {}
    for part, limits in smoke.VQGAN_RESUME_GAP_LIMIT.items():
        for key, limit in limits.items():
            resume = max(r["resume_gap"][part][key] for r in records)
            planted = min(r["planted_fault_gap"][part][key] for r in records)
            planted_dis = min(r["planted_dis_fault_gap"][part][key] for r in records)
            summary[f"{part}.{key}"] = {"largest_resume_gap": resume, "five_times": 5 * resume,
                                        "smallest_planted_gap": planted,
                                        "smallest_planted_dis_gap": planted_dis,
                                        "shipped_limit": limit}
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"size": args.size, "seeds": args.seeds, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
