"""Core of the port: the paper's P2P training loop, exchange and overlay."""
from repro_torch.core.compression import (
    QSGDConfig,
    dequant_reduce,
    dequantize_tree,
    quantize_tree,
)
from repro_torch.core.convergence import (
    ConvergenceDetector,
    EarlyStopping,
    ReduceLROnPlateau,
)
from repro_torch.core.events import LinkModel
from repro_torch.core.exchange import (
    ExchangeContext,
    ExchangeProtocol,
    available_exchanges,
    get_exchange,
    register_exchange,
)
from repro_torch.core.graph import (
    PeerGraph,
    StaticGraph,
    available_graphs,
    get_graph,
    register_graph,
)
from repro_torch.core.mailbox import HostMailbox
from repro_torch.core.p2p import (
    Topology,
    TrainState,
    as_train_state,
    build_p2p_train_step,
    exchange_context,
    exchange_gradients,
    init_ef,
)
from repro_torch.core.simulate import LocalP2PCluster, PeerState

__all__ = [
    "QSGDConfig",
    "quantize_tree",
    "dequantize_tree",
    "dequant_reduce",
    "ConvergenceDetector",
    "EarlyStopping",
    "ReduceLROnPlateau",
    "LinkModel",
    "ExchangeContext",
    "ExchangeProtocol",
    "available_exchanges",
    "get_exchange",
    "register_exchange",
    "PeerGraph",
    "StaticGraph",
    "available_graphs",
    "get_graph",
    "register_graph",
    "HostMailbox",
    "LocalP2PCluster",
    "PeerState",
    "Topology",
    "TrainState",
    "as_train_state",
    "build_p2p_train_step",
    "exchange_context",
    "exchange_gradients",
    "init_ef",
]
