"""The port's train loop, checkpoint manager and entry points against the
JAX package's, on the CPU: the same save sequence gives the same manifest,
`latest`, `best` and pruned directories; the same stub trainer gives the
same metrics records and checkpoint steps; a resumed run equals a straight
one bit for bit; the two CLIs run in-process and write their outputs.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ggrt_official_tpu import config as jcfg
from ggrt_official_tpu.training import checkpoint as jckpt
from ggrt_official_tpu.training import loop as jloop
from ggrt_official_torch import config as tcfg
from ggrt_official_torch.data import datasets as tds
from ggrt_official_torch.evaluation import harness as tharness
from ggrt_official_torch.scripts import eval_ggrt, train_ggrt
from ggrt_official_torch.training import checkpoint as tckpt
from ggrt_official_torch.training import loop as tloop
from ggrt_official_torch.training import state as tstate
from ggrt_official_torch.training.trainer import GGRtTrainer
from tests.test_torch_models import port_cfg
from tests.test_torch_train import TwoGroups, import_beside_placeholders  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work: at these sizes a
    pool gains nothing, and the suite runs several test processes on a few
    cores, where every process's pool spinning on all of them slows each
    step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiny_config_is_the_jax_tiny_config():
    assert dataclasses.asdict(tcfg.tiny_config()) == dataclasses.asdict(port_cfg(graft._tiny_cfg()))


def top_level(path):
    return sorted(os.listdir(path))


def manager_state(path):
    with open(os.path.join(path, "checkpoints.json")) as f:
        manifest = json.load(f)
    return manifest, os.readlink(os.path.join(path, "latest")), top_level(path)


# (step, score): a duplicate step (the loop's final save at a cadence step),
# scores that do and do not improve, and more saves than max_to_keep.
SAVES = [(1, None), (2, 0.5), (3, 0.3), (4, 0.9), (4, None), (5, 0.7), (6, None), (7, 0.95)]


def test_manager_matches_jax(tmp_path):
    """Three saves kept, then a new manager on the same directory (the
    manifest read back) and one more save: the same manifest (kept list and
    best score), `latest` target and directories after each, and `best`
    holding the same save."""
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    managers = {"jax": jckpt.CheckPointManager(dirs["jax"], max_to_keep=3),
                "port": tckpt.CheckPointManager(dirs["port"], max_to_keep=3)}
    for i, (step, score) in enumerate(SAVES):
        if i == len(SAVES) - 1:
            managers = {"jax": jckpt.CheckPointManager(dirs["jax"], max_to_keep=3),
                        "port": tckpt.CheckPointManager(dirs["port"], max_to_keep=3)}
        managers["jax"].save(step, {"w": np.full(3, step, np.float32)}, score=score)
        managers["port"].save(step, {"w": torch.full((3,), float(step))}, score=score)
        assert manager_state(dirs["port"]) == manager_state(dirs["jax"]), (step, score)
    best_j = managers["jax"].load(os.path.join(dirs["jax"], "best"))
    best_t = managers["port"].load(os.path.join(dirs["port"], "best"))
    assert best_t["step"] == best_j["step"] == 7
    np.testing.assert_array_equal(best_t["state"]["w"].numpy(), best_j["state"][0])
    latest = managers["port"].load()
    assert latest["step"] == 7 and torch.equal(latest["state"]["w"], torch.full((3,), 7.0))
    assert tckpt.CheckPointManager(str(tmp_path / "empty")).load() is None


class JaxStub:
    """A trainer for JAX's train_loop: a numpy state that counts steps."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.state = {"w": np.zeros(3, np.float32)}

    def train_iteration(self, batch, machine="joint"):
        self.state = {"w": self.state["w"] + 1}
        return {"loss_all": np.float32(0.5), "psnr": np.float32(20.0), "rel_poses": np.zeros((2, 1, 6), np.float32)}


class PortStub:
    """The port's counterpart: a two-group module with its TrainState, a
    generator, and a step of unit gradients."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.device = torch.device("cpu")
        self.model = TwoGroups({"a": np.zeros(3, np.float32)}, {"b": np.zeros(3, np.float32)})
        self.state = tstate.TrainState(cfg, self.model)
        self.generator = torch.Generator().manual_seed(0)

    def train_iteration(self, batch, machine="joint"):
        for p in self.model.parameters():
            p.grad = torch.ones_like(p)
        self.state.apply_updates(tstate.state_id(machine))
        torch.rand(1, generator=self.generator)
        return {"loss_all": torch.tensor(0.5), "psnr": torch.tensor(20.0), "rel_poses": torch.zeros(2, 1, 6)}


def loop_cfgs():
    cfgs = []
    for mod in (jcfg, tcfg):
        cfg = mod.GGRtConfig()
        cfg.train.n_tensorboard, cfg.train.n_checkpoint, cfg.train.n_validation = 2, 3, 3
        cfgs.append(cfg)
    return cfgs


def records(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [(r["step"], sorted(r)) for r in map(json.loads, f)]


def test_loop_matches_jax(tmp_path):
    """JAX's train_loop and the port's, each with its stub trainer, run to
    step 7 and then resume to step 10: the same metrics records (steps and
    keys, iters_per_s among them), the same checkpoint directories,
    manifests and `latest`, `best` at the best validation score, and the
    resumed runs start where the first ended."""
    jc, tc = loop_cfgs()
    scores = {3: 0.4, 6: 0.9, 9: 0.2}
    out = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    for n_iters in (7, 10):
        jloop.train_loop(JaxStub(jc), iter(lambda: {}, None), out["jax"], n_iters=n_iters,
                         validate_fn=lambda tr: scores[int(tr.state["w"][0])])
        port = PortStub(tc)
        tloop.train_loop(port, iter(lambda: {}, None), out["port"], n_iters=n_iters,
                         validate_fn=lambda tr: scores[tr.state.step])
        assert records(out["port"]) == records(out["jax"])
        ck = {k: os.path.join(v, "checkpoints") for k, v in out.items()}
        assert manager_state(ck["port"]) == manager_state(ck["jax"])
        assert port.state.step == n_iters and port.state.pose_opt.count == n_iters
    assert [s for s, _ in records(out["port"])] == [2, 4, 6, 8, 10]
    best = tckpt.CheckPointManager(ck["port"]).load(os.path.join(ck["port"], "best"))
    assert best["step"] == 6 and best["state"]["train_step"] == 6
    with open(os.path.join(out["port"], "log.txt")) as f:
        assert "resumed from step 7" in f.read()


def test_loop_writes_profile_trace(tmp_path):
    """cfg.train.profile_dir: steps [profile_step, profile_step + 3) traced
    and written as a Chrome trace."""
    _, cfg = loop_cfgs()
    cfg.train.profile_dir = str(tmp_path / "prof")
    cfg.train.profile_step = 1
    tloop.train_loop(PortStub(cfg), iter(lambda: {}, None), str(tmp_path / "run"), n_iters=5)
    with open(os.path.join(cfg.train.profile_dir, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def dryrun_trainer():
    cfg = port_cfg(graft._dryrun_cfg())
    cfg.train.n_tensorboard = 1
    tr = GGRtTrainer(cfg, device="cpu")
    tr.init_full()
    return tr


def dataset_batches(i=0):
    """The dataset's views in turn, from view i."""
    ds = tds.SyntheticPlanesDataset(tds.SyntheticSceneSpec(n_views=8, image_size=(32, 64)), num_source_views=3)
    while True:
        yield tds.collate_batch(ds[i % len(ds)])
        i += 1


def test_resume_is_bit_exact(tmp_path):
    """At __graft_entry__._dryrun_cfg() widths: 4 straight 'joint' steps
    equal 2 steps, the final save, a fresh trainer that resumes from
    `latest`, and 2 more steps, bit for bit: the weights, both Adam states
    and counts, the train step and the generator (the depth-sampling draws
    come from it). train_loop, as JAX's, takes batches from the iterator it
    is given and skips none on resume: the resumed run's starts at the
    third view."""
    straight = tloop.train_loop(dryrun_trainer(), dataset_batches(), str(tmp_path / "a"), n_iters=4)
    tloop.train_loop(dryrun_trainer(), dataset_batches(), str(tmp_path / "b"), n_iters=2)
    resumed = dryrun_trainer()
    tloop.train_loop(resumed, dataset_batches(2), str(tmp_path / "b"), n_iters=4)
    a, b = tloop.checkpoint_state(straight), tloop.checkpoint_state(resumed)
    assert a["train_step"] == b["train_step"] == 4
    assert a["model"].keys() == b["model"].keys()
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    for k in ("gaussian", "pose"):
        assert a["optimizers"][k]["count"] == b["optimizers"][k]["count"] == 4
        sa, sb = a["optimizers"][k]["adam"]["state"], b["optimizers"][k]["adam"]["state"]
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[i][n], sb[i][n]) for i in sa for n in sa[i])
    assert torch.equal(a["generator"], b["generator"])
    assert [s for s, _ in records(str(tmp_path / "b"))] == [1, 2, 3, 4]


def test_model_only_load(tmp_path):
    """A model-only partial load sets the weights and leaves the optimizers,
    the step and the generator as they were."""
    src, dst = dryrun_trainer(), dryrun_trainer()
    with torch.no_grad():
        for p in src.model.parameters():
            p.add_(1.0)
    src.state.step = 5
    state = tloop.checkpoint_state(src)
    gen = dst.generator.get_state()
    tloop.restore_state(dst, state, model_only=True)
    assert all(torch.equal(p, q) for p, q in zip(src.model.state_dict().values(), dst.model.state_dict().values()))
    assert dst.state.step == 0 and dst.state.pose_opt.count == 0 and torch.equal(dst.generator.get_state(), gen)


def test_clis(tmp_path, monkeypatch, capsys):
    """train_ggrt and eval_ggrt in-process at --tiny widths on the CPU: the
    train run logs step 2 and saves it; the eval run loads that checkpoint
    and writes results.json for one view. Without --synthetic both refuse
    (the LLFF readers are ROADMAP Queue 6)."""
    for main in (train_ggrt.main, eval_ggrt.main):
        with pytest.raises(NotImplementedError, match="Queue 6"):
            main(["--device", "cpu", "--out", str(tmp_path / "none")])
    train_out = tmp_path / "train"
    train_ggrt.main(["--synthetic", "--tiny", "--n_iters", "2", "--device", "cpu", "--out", str(train_out)])
    assert [s for s, _ in records(str(train_out))] == [2]
    assert os.readlink(train_out / "checkpoints" / "latest") == "ckpt_00000002"

    time_render = tharness.Evaluator.time_render
    monkeypatch.setattr(tharness.Evaluator, "time_render", lambda self, b, iters=20: time_render(self, b, iters=1))
    eval_out = tmp_path / "eval"
    summary = eval_ggrt.main(["--synthetic", "--tiny", "--limit", "1", "--device", "cpu", "--out", str(eval_out),
                              "--ckpt", str(train_out / "checkpoints" / "latest")])
    assert "loaded checkpoint at step 2" in capsys.readouterr().out
    res = json.loads((eval_out / "results.json").read_text())
    assert res["summary"]["n_views"] == 1 and np.isfinite(res["summary"]["psnr"]) == np.isfinite(summary["psnr"])
