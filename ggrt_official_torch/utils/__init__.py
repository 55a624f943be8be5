"""Camera trajectories for the video renderer (torch tensors), the
benchmarker and the cross-process step tracker."""
from .benchmarker import Benchmarker
from .step_tracker import StepTracker
