"""The node runtime: per-node consensus facade (Core) and the gossip
agent (Node) with its state machine, heartbeat timer, and peer
selection — reference node/ package."""

from .config import Config
from .control_timer import ControlTimer
from .core import Core
from .node import Node
from .peer_selector import (
    HealthTrackingPeerSelector,
    PeerSelector,
    RandomPeerSelector,
)
from .state import NodeState

__all__ = [
    "Config",
    "ControlTimer",
    "Core",
    "HealthTrackingPeerSelector",
    "Node",
    "NodeState",
    "PeerSelector",
    "RandomPeerSelector",
]
