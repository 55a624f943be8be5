"""Multi-scene generalizable training datasets (host-side; the reference's
llff.py LLFFDataset on real_iconic_noface and ibrnet_collected.py; the
JAX package's data/collections.py). Both walk a directory of LLFF-format
scene folders and leave out folders that do not load."""
from __future__ import annotations

import os

from .datasets import LLFFScenes


class LLFFSceneCollection(LLFFScenes):
    """Directory-of-LLFF-scenes dataset."""

    def __init__(self, scene_dirs: list[str], mode: str = "train", num_source_views: int = 5,
                 image_size=(320, 448), factor: int = 8, llffhold: int = 8):
        super().__init__(scene_dirs, mode, num_source_views, llffhold, image_size, factor,
                         skip_unreadable=True)


def _scene_dirs(root: str) -> list[str]:
    if not os.path.isdir(root):
        return []
    return [os.path.join(root, d) for d in sorted(os.listdir(root)) if os.path.isdir(os.path.join(root, d))]


class LLFFDataset(LLFFSceneCollection):
    """Multi-scene LLFF training set (real_iconic_noface), ref llff.py:27."""

    def __init__(self, rootdir: str, mode: str = "train", **kw):
        super().__init__(_scene_dirs(os.path.join(rootdir, "real_iconic_noface")), mode, **kw)


class IBRNetCollectedDataset(LLFFSceneCollection):
    """ibrnet_collected_1 + ibrnet_collected_2, ref ibrnet_collected.py:30."""

    def __init__(self, rootdir: str, mode: str = "train", **kw):
        dirs = (_scene_dirs(os.path.join(rootdir, "ibrnet_collected_1"))
                + _scene_dirs(os.path.join(rootdir, "ibrnet_collected_2")))
        super().__init__(dirs, mode, **kw)
