"""The distributed communication backend.

Two RPC verbs (Sync = pull, EagerSync = push) over a pluggable
Transport seam — reference net/transport.go:25-41, net/commands.go:5-27.
Implementations: InmemTransport (in-process mailboxes, the no-network
multi-node fabric) and TCPTransport (1 type byte + JSON framing, wire
compatible with the reference's net_transport.go:33-46).
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
from .faulty_transport import FaultSpec, FaultyTransport
from .inmem_transport import InmemTransport, new_inmem_addr
from .tcp_transport import TCPTransport

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
    "FaultSpec",
    "FaultyTransport",
    "InmemTransport",
    "new_inmem_addr",
    "TCPTransport",
]
