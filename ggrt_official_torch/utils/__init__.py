"""Camera trajectories for the video renderer (torch tensors), the
benchmarker, the cross-process step tracker and the port's spans
(`tracing`)."""
from .benchmarker import Benchmarker
from .step_tracker import StepTracker
