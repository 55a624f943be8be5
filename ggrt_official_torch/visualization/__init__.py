"""Visualization suite in torch, on the inputs' device (the JAX package's
visualization/): distance-field drawing, layout, colour maps, cameras."""
from .annotation import add_label, draw_text
from .cameras import draw_cameras, render_projections, unproject_frustum_corners
from .color_map import apply_color_map, apply_color_map_to_image
from .drawing import draw_lines, draw_points
from .feature_visualizer import visualize_attention, visualize_features
from .layout import add_border, hcat, resize, vcat

__all__ = [
    "add_border", "add_label", "apply_color_map", "apply_color_map_to_image",
    "draw_cameras", "draw_lines", "draw_points", "draw_text", "hcat",
    "render_projections", "resize", "unproject_frustum_corners", "vcat",
    "visualize_attention", "visualize_features",
]
