"""piquant_tpu_torch.serving — continuous-batching inference engine."""

from piquant_tpu_torch.serving.engine import Engine, EngineConfig, Request  # noqa: F401
from piquant_tpu_torch.serving.sampler import SamplingParams, sample  # noqa: F401
