"""A frozen copy of the plain PyTorch paths of `ggrt_official_torch`, the
benchmark's reference for GGRt's model, rasterizer, losses and trainers.

Copied from the port at the commit that introduced the benchmark, with the
same module tree, so that later changes to the program cannot move the
yardstick. Edits against the copied sources:

- no hand-written kernel: every rasterizer backend is the "tiled" plain
  compositor, its record gather's pullback is `index_add_`
  (`ops/rasterizer/composite.py::GatherRows`), and the banked binning is
  gone from `tiling.py`;
- no initialisers and no pretrained trunks: the models are built on the
  device with torch's defaults, and the benchmark loads every parameter;
- nothing here sets TF32: the caller chooses float32 or its control.

It imports torch and numpy only: nothing of `ggrt_official_torch`, `jax`
or `ggrt_official_tpu`.
"""
