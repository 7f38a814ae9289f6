"""Standing queries (counterpart of ``filodb_tpu/standing/``): dashboards
kept by delta refreshes, pushed to SSE subscribers, and recording rules.
``maintainer.py`` describes the design."""

from .hub import CLOSED, Subscription, SubscriptionHub, SubscriptionLimit
from .maintainer import DEFAULTS as STANDING_DEFAULTS
from .maintainer import StandingEngine
from .registry import DEMOTE_REASONS, StandingQuery, StandingRegistry

__all__ = [
    "CLOSED",
    "DEMOTE_REASONS",
    "STANDING_DEFAULTS",
    "StandingEngine",
    "StandingQuery",
    "StandingRegistry",
    "Subscription",
    "SubscriptionHub",
    "SubscriptionLimit",
]
