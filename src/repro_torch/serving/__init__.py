"""Serving layer of the port: the engine (batch and continuous loops), its
completion worker, the bulk lane's batched generation, and multi-replica
serving (the router, the fault machinery and ``ReplicatedEngine``)."""

from . import engine, faults, generate, pipeline, replica, router  # noqa: F401
