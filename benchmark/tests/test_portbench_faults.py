"""The comparison fails a run whose timed path is broken underneath: a small
run of each cell on the CPU, past the look for a card, with one fault
planted in the program, must come out not correct."""
import pytest

from helpers import run_cell


def test_serve_answer_altered(monkeypatch):
    """A rendered colour altered where it is produced: the channels come out
    in the wrong order."""
    from ggrt_official_torch.ops.rasterizer import api

    real = api.render

    def render(*args, **kwargs):
        return real(*args, **kwargs).flip(1)
    monkeypatch.setattr(api, "render", render)
    assert not run_cell("pretrain-llff.serve")["correct"]


def test_serve_takes_half_the_batch(monkeypatch):
    """Half of the context pairs' Gaussians left out of the render."""
    from ggrt_official_torch.models import pixelsplat

    real = pixelsplat.merge_pair_gaussians

    def merge(g, batch):
        return real(type(g)(*(t[: max(t.shape[0] // 2, 1)] for t in g)), batch)
    monkeypatch.setattr(pixelsplat, "merge_pair_gaussians", merge)
    assert not run_cell("pretrain-llff.serve")["correct"]


def test_serve_pose_altered(monkeypatch):
    """IPO-Net's poses altered where they are produced."""
    from ggrt_official_torch.models.ggrt import GGRtModel

    real = GGRtModel.iponet

    def iponet(self, *args, **kwargs):
        inv, rel, sfm, fmap = real(self, *args, **kwargs)
        return inv, rel * 1.001, sfm, fmap
    monkeypatch.setattr(GGRtModel, "iponet", iponet)
    assert not run_cell("pretrain-llff.serve")["correct"]


def test_frames_answer_altered(monkeypatch):
    """A frame altered where it is produced: its channels in the wrong
    order."""
    from ggrt_official_torch.scripts import render_video

    real = render_video.decode_frame

    def decode_frame(*args, **kwargs):
        return real(*args, **kwargs).flip(-1)
    monkeypatch.setattr(render_video, "decode_frame", decode_frame)
    assert not run_cell("pretrain-llff.frames")["correct"]


STEPS = ["finetune-llff.step", "pretrain-llff.train"]


@pytest.mark.parametrize("name", STEPS)
def test_step_leaves_state_unchanged(monkeypatch, name):
    from ggrt_official_torch.training import state

    monkeypatch.setattr(state.GatedAdam, "step", lambda self, on: None)
    assert not run_cell(name)["correct"]


@pytest.mark.parametrize("name", STEPS)
def test_step_takes_half_the_batch(monkeypatch, name):
    """Half of the rendered pixels left out of the loss, the mean taken over
    the rest."""
    from ggrt_official_torch.training import trainer

    def half(ret, gt):
        h = ret["rgb"].shape[-2] // 2
        return ((ret["rgb"][..., :h, :] - gt["rgb"][..., :h, :]) ** 2).mean()
    monkeypatch.setattr(trainer, "masked_l2_image_loss", half)
    assert not run_cell(name)["correct"]


@pytest.mark.parametrize("name", STEPS)
def test_step_update_altered(monkeypatch, name):
    """The step's update altered where it is produced: the pose learner's
    optimizer step left out."""
    from ggrt_official_torch.training import state

    def apply_updates(self, machine_state):
        self.gaussian_opt.step(machine_state in (state.STATE_NERF_ONLY, state.STATE_JOINT))
        self.step += 1
    monkeypatch.setattr(state.TrainState, "apply_updates", apply_updates)
    assert not run_cell(name)["correct"]
