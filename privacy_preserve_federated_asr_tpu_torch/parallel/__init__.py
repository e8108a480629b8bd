"""The port's parallel layer: the FedAvg family (``fed.py``) and client
partitions (``sampling.py``), and the layouts of one process (rank) per
device under ``torch.distributed`` (``dist.py``): meshes over the ranks
(``mesh.py``), ZeRO-1 (``zero.py``), tensor parallelism (``tp.py``), the
stack-parallel forward (``stacked.py``) with its GPipe (``pp.py``) and
sequence-parallel (``sp.py``) stacks, and what a Trainer installs for them
(``layout.py``).

The exports are the JAX ``parallel/__init__.py``'s that have a counterpart
here. Left out: ``fedavg_stacked``, ``dp_fedavg_stacked`` and
``secagg_payloads``, whose JAX forms take client-stacked pytrees of one
program; the port sums clients one at a time (``FedAvgAccumulator``,
``dp_fedavg``, ``SecAggAccumulator(keep_payloads=True)``). ``zero1_opt_shardings``
and ``zero1_state_shardings`` answer with specs by parameter name, where
JAX answers with ``NamedSharding`` trees.
"""

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
from .mesh import Mesh, make_mesh, make_multislice_mesh, replicated, shard_leading_axis
from .pp import make_pp_forward, make_pp_stack, validate_pp
from .sampling import iid_partition, noniid_shard_partition, noniid_unequal_partition
from .sp import make_sp_forward, make_sp_stack
from .stacked import make_composed_forward
from .tp import tp_partition_spec, tp_shardings, validate_tp_divisibility
from .zero import zero1_opt_shardings, zero1_partition_spec, zero1_state_shardings

__all__ = ["NETWORKS", "CompressedDeltaAccumulator", "FedAvgAccumulator", "Mesh",
           "SecAggAccumulator", "TopKDeltaAccumulator", "average_weights",
           "compressed_delta_fedavg", "dp_fedavg", "graft_network", "iid_partition",
           "make_composed_forward", "make_mesh", "make_multislice_mesh", "make_pp_forward",
           "make_pp_stack", "make_sp_forward", "make_sp_stack", "network_mask",
           "noniid_shard_partition", "noniid_unequal_partition", "replicated",
           "secure_aggregate_fedavg", "select_network", "shard_leading_axis",
           "topk_delta_fedavg", "tp_partition_spec", "tp_shardings",
           "validate_pp", "validate_tp_divisibility", "zero1_opt_shardings",
           "zero1_partition_spec", "zero1_state_shardings"]
