"""Serving: voxel-uncertainty streaming over compiled plans, Bayesian LM
generation, the continuous-batching server that pools both, and the
fault-tolerant router over several such servers."""

from repro_torch.serving.engine import (  # noqa: F401
    ServeConfig, generate, plan_chunk_runner, predict_packed, predict_volume,
    serve_uncertain, uncertainty_decode_step)
from repro_torch.serving.faults import FaultEvent, FaultPlan  # noqa: F401
from repro_torch.serving.metrics import (  # noqa: F401
    MetricsCollector, RequestTimeline, ServingSummary)
from repro_torch.serving.router import (  # noqa: F401
    RouterConfig, RouterSummary, ServingRouter, WorkRecord)
from repro_torch.serving.server import (  # noqa: F401
    BayesianLMServer, QueueFullError, Request, RequestState, ServerConfig,
    StepFns, VoxelScanRequest, WorkItem, step_fns)
