"""Serving: voxel-uncertainty streaming over compiled plans, Bayesian LM
generation, and the continuous-batching server that pools both."""

from repro_torch.serving.engine import (  # noqa: F401
    ServeConfig, generate, plan_chunk_runner, predict_packed, predict_volume,
    serve_uncertain, uncertainty_decode_step)
from repro_torch.serving.metrics import (  # noqa: F401
    MetricsCollector, RequestTimeline, ServingSummary)
from repro_torch.serving.server import (  # noqa: F401
    BayesianLMServer, QueueFullError, Request, RequestState, ServerConfig,
    StepFns, VoxelScanRequest, WorkItem, step_fns)
