from .fed import (
    NETWORKS,
    CompressedDeltaAccumulator,
    FedAvgAccumulator,
    SecAggAccumulator,
    TopKDeltaAccumulator,
    average_weights,
    compressed_delta_fedavg,
    dp_fedavg,
    graft_network,
    network_mask,
    secure_aggregate_fedavg,
    select_network,
    topk_delta_fedavg,
)
from .sampling import iid_partition, noniid_shard_partition, noniid_unequal_partition

__all__ = ["NETWORKS", "CompressedDeltaAccumulator", "FedAvgAccumulator",
           "SecAggAccumulator", "TopKDeltaAccumulator", "average_weights",
           "compressed_delta_fedavg", "dp_fedavg", "graft_network", "iid_partition",
           "network_mask", "noniid_shard_partition", "noniid_unequal_partition",
           "secure_aggregate_fedavg", "select_network", "topk_delta_fedavg"]
