"""Test fixtures of the port (an own copy of ``kubernetes_tpu/testing/``):
the device-service fault script, the store's reaction hooks, and the
lock-order / blocking-under-lock tracer that the port's lock factories route
through (``locktrace``; a plain ``threading`` primitive unless
``KTPU_LOCKTRACE=1``)."""

from . import locktrace
from .faults import Fault, FaultPlan
from .reactors import ReactionError, with_reactors

__all__ = ["Fault", "FaultPlan", "ReactionError", "locktrace",
           "with_reactors"]
