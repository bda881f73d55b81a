"""Serving engine of the port (single device, dense paged KV)."""
from repro_torch.serve.engine import (BlockAllocator, Request, RequestFuture,
                                      ServeEngine)

__all__ = ["BlockAllocator", "Request", "RequestFuture", "ServeEngine"]
