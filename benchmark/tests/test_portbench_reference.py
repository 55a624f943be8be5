"""Each cell's reference against the port's own path, at `tiny_config()`
widths on the CPU: a whole small run of the cell, whose checks hold the
program's answers against the frozen reference's."""
import math

import numpy as np
import pytest
import torch

from benchmark import common, weights
from benchmark.loops import serve
from helpers import SMALL, ctx_of, run_cell


@pytest.mark.parametrize("name", sorted(SMALL))
def test_cell_agrees_with_reference(name):
    line = run_cell(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    for c in line["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]


def test_serve_request_both_sides():
    """One request through the port and through the reference, from the same
    seeded weights and inputs: poses equal to rounding, renders close."""
    ctx = ctx_of("pretrain-llff.serve")
    pool, order = serve.requests(ctx)
    out = []
    for program in (True, False):
        GGRtModel, prepare_batch, get_data_shim, rel = serve.sides(program)
        cfg = (common.program_config if program else common.reference_config)(ctx["cell"])
        model = GGRtModel(cfg, device="cpu")
        weights.load_params(model, serve.make_params(model, ctx))
        out.append(serve.request(model, prepare_batch, get_data_shim(cfg.encoder), rel, pool[order[0]], "cpu"))
    np.testing.assert_allclose(out[0]["poses"], out[1]["poses"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[0]["rgb"], out[1]["rgb"], rtol=0, atol=1e-4)
    assert float(np.var(out[0]["rgb"])) > 0


def test_weights_are_seeded_and_shaped():
    shapes = [("a.weight", (4, 3, 3, 3)), ("a.bias", (4,)), ("n.weight", (4,))]
    p = weights.make_params(shapes, 7, "cpu")
    q = weights.make_params(shapes, 7, "cpu")
    r = weights.make_params(shapes, 8, "cpu")
    assert all(torch.equal(p[k], q[k]) for k in p) and not torch.equal(p["a.weight"], r["a.weight"])
    assert float(p["a.weight"].abs().max()) <= (3.0 / 27) ** 0.5
    assert float((p["n.weight"] - 1).abs().max()) <= 0.1 and float(p["a.bias"].abs().max()) <= 0.01
