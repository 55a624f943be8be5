"""On the card, at each cell's own size: the control (the reference with
TF32 in the program's place) fails the cell's comparison, and the program's
own sound readings pass it. One seed each; PERF.md gives the readings over
more."""
import pytest
import torch

from benchmark import spec

CELLS = ["pretrain-llff.serve", "pretrain-llff.frames", "finetune-llff.step", "pretrain-llff.train"]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def ctx_on(card, name, seed):
    return {"cell": spec.cell(spec.load(), name), "name": name, "seed": seed, "trace": False, "device": card}


def failed(checks):
    return [c["name"] for c in checks if not c["value"] <= c["limit"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(card, name):
    ctx = ctx_on(card, name, 2**31 + 21)
    loop = spec.loop(ctx["cell"]["traffic"]["loop"])
    assert failed(loop.control(ctx, loop.inputs(ctx)))


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_program_passes(card, name):
    ctx = ctx_on(card, name, 2**31 + 22)
    loop = spec.loop(ctx["cell"]["traffic"]["loop"])
    assert not failed(loop.check(ctx, loop.sound(ctx)))
