"""Offline SfM pipeline (host-side; the JAX package's sfm/).

The reference shells out to hloc (SuperPoint/SuperGlue/NetVLAD) + COLMAP
(its scripts/extract_relative_poses.py and preprocess_dbarf_dataset.py);
the same pipeline stages are built on numpy and OpenCV with matching
interfaces. Retrieval needs numpy and PIL only; the two-view geometry
(SIFT, FLANN, the essential matrix) imports OpenCV where it runs:

  retrieval.py       — global descriptors + top-k pair selection
                       (pairs_from_retrieval equivalent)
  two_view.py        — SIFT features, ratio matching, essential-matrix
                       two-view geometries
  disambiguation.py  — geodesic-consistency match scoring + filters
                       (calculate_geodesic_consistency_scores /
                       filter_matches equivalents)
  pipeline.py        — the whole run: images -> view graph (g2o) ->
                       MST-initialized global poses -> poses_bounds.npy
"""
from .pipeline import run_sfm_pipeline  # noqa: F401
