"""Serving layer: recommendation service, micro-batcher, threaded and
asyncio HTTP API, with the JAX package's endpoint and status-code
contract.

Importing the package loads neither torch nor numpy (the serve CLI sets
the BLAS thread counts of forked workers before they load);
``RecommendationService`` and ``StubRecommendationService`` import
``serve.service`` on first access.
"""

# the JAX package's backends
BACKENDS = ("auto", "device", "native", "sharded", "exported")

__all__ = ["BACKENDS", "RecommendationService", "StubRecommendationService"]


def __getattr__(name):
    if name in ("RecommendationService", "StubRecommendationService"):
        from recsys_tpu_torch.serve import service

        return getattr(service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
