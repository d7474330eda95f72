"""Serving layer: recommendation service + threaded HTTP API, with the
JAX package's endpoint and status-code contract."""

from recsys_tpu_torch.serve.service import RecommendationService, StubRecommendationService

__all__ = ["RecommendationService", "StubRecommendationService"]
