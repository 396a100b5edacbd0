"""Typed serving errors: the structured failure surface of
``repro_torch.serve``.

``PlacementService`` promises that ``submit``/``poll``/``flush`` never
leak a raw ``AssertionError``/``ValueError`` for a bad *request*: every
request completes with either a legal placement or a ``ServeResult``
carrying one of these typed errors, so a stream replay survives
malformed tasks, lost capacity, and busted decode deadlines without an
exception unwinding the whole admission loop.

The hierarchy is deliberately small:

* ``IllegalTaskError``     -- the request itself is malformed (wrong
  feature width, non-finite values, no tables, bad device count);
* ``CapacityError``        -- the task is well-formed but no legal
  placement exists on the (possibly degraded) mesh: every stage of the
  fallback chain failed the memory check;
* ``DecodeTimeout``        -- the decode deadline was busted and the
  fallback chain was disabled, so nothing could serve the bucket;
* ``TransientOracleError`` -- a cost-oracle measurement failed in a
  retryable way (raised by ``FaultInjector``-wrapped oracles; the
  service retries with backoff and degrades gracefully on exhaustion --
  this one is *handled internally* and only surfaces in telemetry).
"""

from __future__ import annotations


class ServeError(Exception):
    """Base of every typed serving error.

    ``code`` is a stable machine-readable slug (mirrors the class name)
    so structured consumers (benchmarks, log pipelines) can switch on it
    without string-matching messages.
    """

    code = "serve_error"

    def describe(self) -> dict:
        """Structured view for logs / benchmark JSON."""
        return {"code": self.code, "message": str(self)}


class IllegalTaskError(ServeError):
    """The request is malformed; no placement can even be attempted."""

    code = "illegal_task"


class CapacityError(ServeError):
    """No legal placement exists on the surviving mesh capacity."""

    code = "capacity"


class DecodeTimeout(ServeError):
    """The decode deadline passed and no fallback stage was allowed."""

    code = "decode_timeout"


class TransientOracleError(ServeError):
    """A retryable cost-oracle failure (injected or real); the service
    retries with bounded backoff and keeps the incumbent on exhaustion."""

    code = "transient_oracle"
