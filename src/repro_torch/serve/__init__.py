"""Serving engine of the port (one device): the paged / slot-state engine,
and the prefill/decode pair over a handoff arena."""
from repro_torch.serve.disagg import DisaggServer
from repro_torch.serve.engine import (BlockAllocator, Request, RequestFuture,
                                      ServeEngine)
from repro_torch.serve.swap import HandoffHandle

__all__ = ["BlockAllocator", "DisaggServer", "HandoffHandle", "Request",
           "RequestFuture", "ServeEngine"]
