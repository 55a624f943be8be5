"""The port's native library bindings (native.py), the GGRT_NATIVE_RESIZE
switch of its LLFF loader, the Benchmarker and the StepTracker, against the
JAX package's on the CPU.

Both packages compile the same unchanged native/ggrt_native.cpp with g++
(each into its own build directory), so the two bindings are held to each
other bit for bit; the port's fallbacks are held to the port's numpy
resize and to numpy.
"""
import json
import multiprocessing
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from ggrt_official_torch import native as tnative
from ggrt_official_torch.data import llff as tllff
from ggrt_official_torch.data.image_io import resize as tresize
from ggrt_official_torch.utils import Benchmarker, StepTracker
from ggrt_official_tpu import native as jnative
from ggrt_official_tpu.data import llff as jllff


@pytest.fixture(scope="module")
def built():
    """Both libraries built and loaded."""
    assert tnative.available(), tnative.build_log
    assert jnative.get_lib() is not None
    return tnative.get_lib()


@pytest.fixture
def no_library(monkeypatch):
    """The port's bindings as on a machine where the library cannot be built."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    assert not tnative.available()


def images():
    rng = np.random.RandomState(0)
    return [rng.rand(64, 96, 3).astype(np.float32), rng.rand(6, 6, 3).astype(np.float32),
            rng.rand(37, 53, 1).astype(np.float32)]


@pytest.mark.parametrize("out_hw", [(16, 24), (12, 12), (20, 30)])
def test_resize_is_jax(built, out_hw):
    """The port's resize_bilinear_aa against JAX's, both native: bit for bit
    (shrinking with the box prefilter and growing)."""
    for img in images():
        np.testing.assert_array_equal(tnative.resize_bilinear_aa(img, out_hw),
                                      jnative.resize_bilinear_aa(img, out_hw))


def test_library_lives_in_the_ports_build_directory(built):
    """The port loads its own build, named by the source's hash, under
    ggrt_official_torch/_build/native/, not the JAX package's native/build/."""
    so = Path(built._name)
    assert so.parent == Path(tnative.__file__).parent / "_build" / "native"
    assert so.name.startswith("libggrt_native_") and so.exists()


def test_pose_distances_is_jax(built):
    rng = np.random.RandomState(1)
    refs = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
    refs[:, :3, 3] = rng.randn(20, 3)
    tar = np.eye(4, dtype=np.float32)
    tar[:3, 3] = [1.0, -2.0, 0.5]
    np.testing.assert_array_equal(tnative.pose_distances(refs, tar), jnative.pose_distances(refs, tar))


def ring_trace(mod):
    """push/pop/len of a capacity-2 ring, and a producer thread through a
    capacity-4 one."""
    ring = mod.PrefetchRing(capacity=2)
    trace = [ring.pop(), ring.push(b"one"), ring.push(b"two"), ring.push(b"three"), len(ring),
             ring.pop(), ring.push(b"three"), ring.pop(), ring.pop(2), len(ring), ring.pop()]
    ring = mod.PrefetchRing(capacity=4)
    blobs = [bytes([i]) * 100 for i in range(20)]

    def produce():
        for b in blobs:
            while not ring.push(b):
                pass

    th = threading.Thread(target=produce)
    th.start()
    got = []
    while len(got) < len(blobs):
        b = ring.pop()
        if b is not None:
            got.append(b)
    th.join(timeout=30)
    assert not th.is_alive()
    return trace + [got == blobs]


def test_ring_is_jax(built):
    assert ring_trace(tnative) == ring_trace(jnative)
    assert ring_trace(tnative)[-1] is True


def test_fallbacks(no_library):
    """Without the library: the resize is the port's blur and bilinear
    resize, bit for bit, and on JAX's case (64x96 to 16x24) within JAX's
    bar of 0.03 mean of the native one (tests/test_native.py:39); the
    distances are numpy's; the ring is a deque with the native ring's
    behaviour (but for cutting a blob)."""
    for img in images():
        for out_hw in ((16, 24), (12, 12)):
            want = tresize(tllff.downsample_gaussian_blur(img, out_hw[0] / img.shape[0]), out_hw, "linear")
            got = tnative.resize_bilinear_aa(img, out_hw)
            np.testing.assert_array_equal(got, want.reshape(got.shape))
    img = images()[0]
    assert np.abs(tnative.resize_bilinear_aa(img, (16, 24)) - jnative.resize_bilinear_aa(img, (16, 24))).mean() < 0.03
    refs = np.random.RandomState(2).randn(5, 4, 4).astype(np.float32)
    np.testing.assert_allclose(tnative.pose_distances(refs, refs[0]),
                               jnative.pose_distances(refs, refs[0]), rtol=1e-6)
    trace = ring_trace(tnative)
    assert trace[:8] == [None, True, True, False, 2, b"one", True, b"two"] and trace[-1] is True


def test_llff_switch(built, monkeypatch):
    """GGRT_NATIVE_RESIZE=1 sends the loader's resize to the native kernel,
    as JAX's loader does (bit for bit with JAX's switched loader); without
    it the loader keeps the numpy blur and resize."""
    rng = np.random.RandomState(3)
    rgb, src = rng.rand(64, 96, 3).astype(np.float32), rng.rand(2, 64, 96, 3).astype(np.float32)
    cam = np.concatenate([[64, 96], np.eye(4).ravel() * 50, np.eye(4).ravel()]).astype(np.float32)
    cams = np.stack([cam, cam])
    plain = tllff.loader_resize(rgb, cam, src, cams, size=(16, 24))
    monkeypatch.setenv("GGRT_NATIVE_RESIZE", "1")
    got = tllff.loader_resize(rgb, cam, src, cams, size=(16, 24))
    want = jllff.loader_resize(rgb, cam, src, cams, size=(16, 24))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], tnative.resize_bilinear_aa(rgb, (16, 24)))
    assert not np.array_equal(got[0], plain[0]) and np.abs(got[0] - plain[0]).mean() < 0.03


def test_benchmarker(tmp_path, monkeypatch):
    """A CPU Benchmarker never calls torch.cuda; its dump is the JSON of its
    tags' per-call seconds (num_calls splits a block evenly) and its memory
    dump an empty JSON object, as the JAX package's on the CPU."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU Benchmarker called torch.cuda")

    for name in ("synchronize", "memory_stats", "device_count", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    bm = Benchmarker(device="cpu")
    with bm.time("a"):
        torch.ones(4).sum()
    with bm.time("b", num_calls=4):
        pass
    with pytest.raises(RuntimeError), bm.time("c"):
        raise RuntimeError("timed even when the block fails")
    bm.dump(tmp_path / "sub" / "times.json")
    times = json.loads((tmp_path / "sub" / "times.json").read_text())
    assert sorted(times) == ["a", "b", "c"] and len(times["b"]) == 4 and len(set(times["b"])) == 1
    assert all(x >= 0 for v in times.values() for x in v)
    assert bm.dump_memory(tmp_path / "mem.json") == {}
    assert json.loads((tmp_path / "mem.json").read_text()) == {}
    bm.summarize()


def test_benchmarker_on_a_card_waits_and_reads_every_card(tmp_path, monkeypatch):
    """With device "cuda" the timer synchronises at entry and exit, and
    dump_memory writes torch.cuda.memory_stats of every card under
    device_{i}, values as ints (the card's calls stubbed here)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(("sync", str(d))))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {"allocated_bytes.all.peak": 10.0 * (i + 1)})
    bm = Benchmarker(device="cuda")
    with bm.time("request"):
        calls.append("work")
    assert calls == [("sync", "cuda"), "work", ("sync", "cuda")]
    stats = bm.dump_memory(tmp_path / "mem.json")
    assert json.loads((tmp_path / "mem.json").read_text()) == stats == {
        "device_0": {"allocated_bytes.all.peak": 10}, "device_1": {"allocated_bytes.all.peak": 20}}


def _child_sets_step(tracker, step):
    tracker.set_step(step)


def test_step_tracker_across_a_spawned_process():
    """A step set in a spawned process is read in this one, and back."""
    tracker = StepTracker()
    tracker.set_step(3)
    ctx = multiprocessing.get_context("spawn")
    proc = ctx.Process(target=_child_sets_step, args=(tracker, 17))
    proc.start()
    proc.join(timeout=60)
    assert proc.exitcode == 0
    assert tracker.get_step() == 17
