"""HTTP observability service — reference service/service.go."""

from .service import Service

__all__ = ["Service"]
