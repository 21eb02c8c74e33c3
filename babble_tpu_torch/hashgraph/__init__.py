"""The hashgraph models, stores and engines of the port (counterpart
of babble_tpu/hashgraph): events with Go-compatible identity, blocks,
roots, frames, round rows, the in-memory store, the host `Hashgraph`
(the reference semantics, and the oracle the device graph is held
against) and `TorchHashgraph`, which runs consensus on the port's
incremental engine, and the sqlite `FileStore`."""

from .event import Event, EventBody, EventCoordinates, WireBody, WireEvent
from .block import Block
from .root import Root, new_base_root
from .frame import Frame
from .round_info import RoundInfo, RoundEvent, Trilean
from .store import Store
from .inmem_store import InmemStore
from .file_store import FileStore
from .graph import ForkError, Hashgraph, InsertError
from .health import BlockHashChain
from .participant_events import ParticipantEventsCache
from .torch_graph import TorchHashgraph

__all__ = [
    "Event",
    "EventBody",
    "EventCoordinates",
    "WireBody",
    "WireEvent",
    "Block",
    "Root",
    "new_base_root",
    "Frame",
    "RoundInfo",
    "RoundEvent",
    "Trilean",
    "Store",
    "InmemStore",
    "FileStore",
    "BlockHashChain",
    "ForkError",
    "Hashgraph",
    "InsertError",
    "ParticipantEventsCache",
    "TorchHashgraph",
]
