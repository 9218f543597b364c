"""Serving layer of the port: the continuous chunked-prefill engine, its
completion worker and the bulk lane's batched generation."""

from . import engine, generate, pipeline  # noqa: F401
