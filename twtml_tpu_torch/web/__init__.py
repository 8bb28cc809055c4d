"""The twtml-web dashboard server of the port (counterpart of
``twtml_tpu/web``): the last-value API cache, the standard-library HTTP and
websocket server, and the dashboard's assets."""

from .cache import ApiCache
from .server import Server

__all__ = ["ApiCache", "Server"]
