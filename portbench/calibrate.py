"""The readings the correctness limits are set from, at a cell's own size
on the card, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 101-112 \
        --faults 3 [--out <file.jsonl>]

For each seed, the program's sound readout of its first steps (the run's
own set-up and steps) against the reference's: the lower readings. For
the first `--faults` seeds also the control, the reference in the program's
place with TF32 products (the precision below the configuration's
float32), and the planted fault of half of the batch left out of the
loss, the mean taken over the rest, each against the reference: the
upper readings. A step that leaves the state unchanged reads 1 in
change_gap by construction and needs no run. One JSON line a seed.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds_of(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="first-last")
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import check, harness, spec
    from portbench import traffic as traffic_mod
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for k, seed in enumerate(seeds_of(args.seeds)):
            t0 = time.perf_counter()
            data = traffic_mod.make(cell.traffic, cell.generator(), seed)
            prog = harness.build_program(cell, data, seed, dev)
            readout = harness.first_steps(prog)
            prog = None
            gc.collect()
            torch.cuda.empty_cache()
            ref = harness.reference_readout(cell, data, seed, dev)
            row = {"workload": cell.name, "seed": seed,
                   "program": check.compare(readout, ref)}
            if k < args.faults:
                for name, mode in (("control", {"control": True}),
                                   ("half_batch", {"half_batch": True})):
                    other = harness.reference_readout(cell, data, seed, dev,
                                                      **mode)
                    row[name] = check.compare(other, ref)
            row["seconds"] = time.perf_counter() - t0
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
