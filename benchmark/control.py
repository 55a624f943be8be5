"""The control of a cell's comparison: the reference computed with TF32 (the
precision just below the configurations' float32 with TF32 off) put in the
program's place, compared with the float32 reference exactly as a run
compares the program. Every number it prints should exceed its limit on
every seed: that is what shows the comparison can fail. With `--program`
it reads the program's own numbers instead, from the same requests, frames
or first steps a run checks but without a window, for the lower readings;
`--fault` plants one of a training cell's faults in the program first.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...] [--program [--fault <f>]]

It needs a CUDA card (TF32 exists only there) and prints one JSON line per
seed, then a summary line with the smallest and largest reading of each
number.
"""
from __future__ import annotations

import argparse
import json
import sys

from benchmark import chip, spec


def _half_batch():
    """Half of the rendered pixels left out of the training loss, the mean
    taken over the rest."""
    from ggrt_official_torch.training import trainer

    def half(ret, gt):
        h = ret["rgb"].shape[-2] // 2
        return ((ret["rgb"][..., :h, :] - gt["rgb"][..., :h, :]) ** 2).mean()
    trainer.masked_l2_image_loss = half


FAULTS = {"half_batch": _half_batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true",
                    help="read the program's own numbers instead (sound runs, no window)")
    ap.add_argument("--fault", choices=sorted(FAULTS),
                    help="with --program: plant this fault in the program first")
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    try:
        torch = chip.require(cell["workload"]["chips"])
    except chip.NoCard as e:
        print(f"control: {e}", file=sys.stderr)
        return 2
    loop = spec.loop(cell["traffic"]["loop"])
    if args.fault:
        FAULTS[args.fault]()
    least: dict[str, float] = {}
    most: dict[str, float] = {}
    for seed in args.seeds:
        ctx = {"cell": cell, "name": args.workload, "seed": seed, "trace": False, "device": torch.device("cuda", 0)}
        checks = loop.check(ctx, loop.sound(ctx)) if args.program else loop.control(ctx, loop.inputs(ctx))
        print(json.dumps({"seed": seed, **{c["name"]: c["value"] for c in checks},
                          "at": {c["name"]: c["at"] for c in checks if c.get("at")}}), flush=True)
        for c in checks:
            least[c["name"]] = min(least.get(c["name"], float("inf")), c["value"])
            most[c["name"]] = max(most.get(c["name"], float("-inf")), c["value"])
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program" if args.program else "control": True,
                      "least": least, "most": most}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
