"""Offline SfM pipeline (host-side; the JAX package's sfm/).

The reference shells out to hloc (SuperPoint/SuperGlue/NetVLAD) + COLMAP
(its scripts/extract_relative_poses.py and preprocess_dbarf_dataset.py);
the JAX package builds the same stages on numpy and OpenCV; the port needs
no OpenCV: retrieval is numpy and PIL, and SIFT, matching and the
essential matrix run in torch on the card (or the CPU):

  retrieval.py       — global descriptors + top-k pair selection
                       (pairs_from_retrieval equivalent)
  sift.py            — SIFT keypoints and descriptors (OpenCV's)
  essential.py       — five-point RANSAC essential matrix, recoverPose
  two_view.py        — features, exact 2-NN ratio matching, two-view
                       geometries
  disambiguation.py  — geodesic-consistency match scoring + filters
                       (calculate_geodesic_consistency_scores /
                       filter_matches equivalents)
  pipeline.py        — the whole run: images -> view graph (g2o) ->
                       MST-initialized global poses -> poses_bounds.npy
"""
from .pipeline import run_sfm_pipeline  # noqa: F401
