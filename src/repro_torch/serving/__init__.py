"""FM-index query serving: the sync micro-batching server and the async
admission-controlled frontend in front of it."""

from .engine import FMQueryServer  # noqa: F401
from .frontend import AsyncQueryFrontend, Rejected  # noqa: F401
