# Copied from the JAX package: paddle_tpu/ps/errors.py
# (stdlib only). Keep it in step with that file.
"""Typed PS-tier errors.

Kept dependency-free (stdlib only) so the training loops
(parallel/train.py) and the resilience layer can catch them without
importing the PS client — and so the PS client itself can raise them
before jax or the framework ever loads.
"""

from __future__ import annotations

__all__ = ["PSError", "PSUnavailableError", "PSTimeoutError"]


class PSError(RuntimeError):
    """Base class for parameter-server tier failures."""


class PSUnavailableError(PSError):
    """A PS server could not be reached within the call's retry budget
    (dead/wedged server, open circuit breaker, exhausted deadline).

    Distinct from a server-side application error ({"error": ...} reply,
    raised as plain RuntimeError): *unavailable* means the request may
    never have been seen, and the resilient client has already retried
    it — the right responses are degrade (buffer pushes), block-and-wait
    (pulls), or a RecoveryPolicy action, never a blind in-place retry."""

    def __init__(self, msg: str, endpoint: str = "", op: str = ""):
        super().__init__(msg)
        self.endpoint = endpoint
        self.op = op


class PSTimeoutError(PSError):
    """A bounded PS wait (wait_var / wait_all_completed) expired.

    The server was reachable the whole time — the awaited *condition*
    (a published var, peers reporting COMPLETED) never became true."""
