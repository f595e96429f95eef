"""The readings that the limits of ``correct`` are set from
(``portbench/limits/<cell>.json``): for each seed, one run of the cell
with the program's numbers and the control's on the same sampled calls,
all in one process (set-up is paid once for the kernels and the CUDA
context).

    python3 -m portbench.readings --workload <name> --seconds <s> --seeds <n> [<n> ...]

prints one JSON line a seed: ``{"seed", "program": {...}, "control": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    spec = run.load_cell(args.workload)
    for seed in args.seeds:
        result, shown = run.run_cell(spec, seed, args.seconds, False, control=True)
        print(json.dumps({"seed": seed, "attempted": result["attempted"],
                          "program": {k: v["value"] for k, v in shown.items()},
                          "control": result["control"], "lock": result["lock"],
                          "state_gap_rows": result["notes"].get("state_gap_rows"),
                          "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
