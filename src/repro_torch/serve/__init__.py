"""Serving layer of the port: multi-tenant counting queries over cached
engines.

``repro_torch.serve.counting`` is the synchronous subgraph-counting service
(engine cache + cross-query batching + adaptive stopping + failure
semantics + tuning hooks); ``repro_torch.serve.frontend`` is the
asynchronous front door above it (futures, per-tenant QoS tiers and rate
limits, cost-model backpressure, streaming progress, background engine
warming and tuning) with its QoS primitives in ``repro_torch.serve.qos``.
``repro_torch.serve.engine`` is the LM ``ServeEngine`` and is NOT imported
here (it pulls in the transformer stack — import it explicitly).
"""

from .cache import EngineCache
from .counting import CountingService, Query, QueryEstimate
from .frontend import (
    QoSRejected,
    QueryFuture,
    ServiceFrontend,
    TemplateProgress,
    make_frontend,
)
from .qos import ManualClock, SystemClock, TenantPolicy, TokenBucket
from .resilience import (
    QuarantinedError,
    RetryPolicy,
    ServiceError,
    classify_failure,
)
from .stopping import AdaptiveStopper, TemplateCI, adaptive_estimate, normal_quantile

__all__ = [
    "EngineCache",
    "CountingService",
    "Query",
    "QueryEstimate",
    "ServiceFrontend",
    "QueryFuture",
    "TemplateProgress",
    "QoSRejected",
    "make_frontend",
    "ManualClock",
    "SystemClock",
    "TenantPolicy",
    "TokenBucket",
    "ServiceError",
    "QuarantinedError",
    "RetryPolicy",
    "classify_failure",
    "AdaptiveStopper",
    "TemplateCI",
    "adaptive_estimate",
    "normal_quantile",
]
