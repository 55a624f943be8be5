"""The whole item's share of the card's float32 peak (%): its FLOPs, counted
once over the benchmark's reference at the cell's shapes and stored in
benchmark/cells/<cell>.json, over the traced window's time per item
(the first item's start to the last one's end in the trace)."""
from benchmark import common, roofline


def read(rec):
    flops = common.cell_data(rec["cell"]["workload"]["name"]).get("flops_per_item")
    if not flops or rec["trace"] is None:
        return None
    tr = rec["trace"]
    return 100.0 * flops / (tr.window_s() / len(tr.items)) / roofline.H100_FP32_FLOPS
