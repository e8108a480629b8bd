from .fed import (
    NETWORKS,
    FedAvgAccumulator,
    average_weights,
    dp_fedavg,
    graft_network,
    network_mask,
    select_network,
)

__all__ = ["NETWORKS", "FedAvgAccumulator", "average_weights", "dp_fedavg",
           "graft_network", "network_mask", "select_network"]
