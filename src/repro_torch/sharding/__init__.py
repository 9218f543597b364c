"""Sharding layer of the port (``repro.sharding``'s counterpart): the
ambient policy context and the logical-axis policy over a ``DeviceMesh``."""

from . import context, policy  # noqa: F401
