"""The distributed communication backend.

Two RPC verbs (Sync = pull, EagerSync = push) over a pluggable
Transport seam — reference net/transport.go:25-41, net/commands.go:5-27.
Implementation in the port: InmemTransport (in-process mailboxes, the
no-network multi-node fabric). The TCP and fault-injecting transports
are not ported yet (ROADMAP A7b).
"""

from .peer import Peer, StaticPeers, JSONPeers, exclude_peer, sort_peers_by_pub_key
from .transport import (
    RPC,
    RPCResponse,
    SyncRequest,
    SyncResponse,
    EagerSyncRequest,
    EagerSyncResponse,
    IHaveRequest,
    IHaveResponse,
    GraftRequest,
    GraftResponse,
    PruneRequest,
    PruneResponse,
    Transport,
    TransportError,
)
from .inmem_transport import InmemTransport, new_inmem_addr

__all__ = [
    "Peer",
    "StaticPeers",
    "JSONPeers",
    "exclude_peer",
    "sort_peers_by_pub_key",
    "RPC",
    "RPCResponse",
    "SyncRequest",
    "SyncResponse",
    "EagerSyncRequest",
    "EagerSyncResponse",
    "IHaveRequest",
    "IHaveResponse",
    "GraftRequest",
    "GraftResponse",
    "PruneRequest",
    "PruneResponse",
    "Transport",
    "TransportError",
    "InmemTransport",
    "new_inmem_addr",
]
