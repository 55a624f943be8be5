"""Phase 19 of chip_smoke.py (`sfm_phase`: SIFT, matching, RANSAC and
recoverPose on the card) of one checkout, with a one-line summary.

Run it as a file, so that the checkout's own package is the one imported:

    python ggrt_official_torch/tools/sfm_ab.py <checkout root> <tag>

Two versions compare on one card by running it once for each checkout in
one command, in the order parent, change, change, parent. The summary
line starts with "AB <tag>" and holds (min, median, max, mean) of SIFT ms
per image, matching and RANSAC + recoverPose ms per pair, host syncs, the
pipeline's and the CLI's seconds and their edges' rotation errors.
"""
import json
import sys
import tempfile
from pathlib import Path


def spread(v):
    return min(v), sorted(v)[len(v) // 2], max(v), sum(v) / len(v)


def main(argv=None):
    root, tag = argv or sys.argv[1:3]
    sys.path.insert(0, str(Path(root).resolve()))
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        o = chip_smoke.sfm_phase(f"[{tag}]", Path(tmp))
    rot = [e[3] for e in o["edges"]]
    cli_rot = [e[3] for e in o["cli_edges"]]
    print("AB", tag, json.dumps({
        "sift_ms": spread(o["sift_ms"]), "match_ms": spread(o["match_ms"]), "geom_ms": spread(o["geom_ms"]),
        "pair_syncs": o["pair_syncs"], "sift_syncs": o["sift_syncs"], "pipeline_s": o["pipeline_s"],
        "cli_s": o["cli_s"], "edges": len(rot), "worst_rot": max(rot), "mean_rot": sum(rot) / len(rot),
        "cli_edges": len(cli_rot), "cli_worst_rot": max(cli_rot), "cli_mean_rot": sum(cli_rot) / len(cli_rot)}),
        flush=True)


if __name__ == "__main__":
    main()
