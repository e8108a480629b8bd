"""Federated learning engine (the port's ``federated/engine.py``).

The JAX engine runs an FL round as ONE jitted program: broadcast the global
params, ``vmap`` the local training scan over the clients, FedAvg over the
client axis, graft the stage's sub-network into the global params. Here the
round runs on one card with the clients one after another:

  * one model instance, loaded from the global state dict at each client's
    start (in each stage only the aggregated sub-network trains, so a
    client's round-start params always equal the global params);
  * a fresh optimizer for each local phase (``total_steps`` = the phase's
    step count), as the reference's per-phase Trainer instances;
  * a running fp32 sum of the stage's sub-network only, in sampled-client
    order (``parallel/fed.py::FedAvgAccumulator``): graft discards every
    other entry of the mean, so no K full copies are ever held.

Every client runs the round's largest step count: the shorter ones end with
all-masked padding batches (zero loss, zero gradient), which are still real
AdamW steps (the moments decay, weight decay applies, the schedule
advances), as in the JAX engine's padded scan.

Client data is resident on the device (uploaded once; rounds send index
batches) or staged per round, chosen as the JAX engine chooses. In stages
1/2 the frozen, deterministic encoder's output of every resident utterance
is cached once and the rounds train the heads on it; the cache is built with
the current global params, lives across ``run_rounds`` calls and is dropped
after any stage-0 training.

The 3-stage pipeline (reference stage{1,2,3}_training,
federated_main.py:148-205): each stage = centralized warm-start on the
public split + FL rounds + graft of the aggregated sub-network. Beside
FedAvg a round aggregates by DP-FedAvg with its RDP accountant, int8 uplink
compression, secure aggregation or top-k sparsification with per-client
error-feedback residuals (``parallel/fed.py``); FedProx adds its proximal
term to every local objective; a FedOpt server optimizer (FedAvgM or
FedAdam, one state per stage) turns the round delta into a step. With
``supervised_level < 1`` an unsupervised phase on ``client_unsup_examples``
runs before the supervised one: CTC on their own (teacher) transcripts, or
with ``num_lms > 1`` the N-best multitask update on pseudo labels that the
round's global model decodes (``federated/multitask.py``). Round r+1 is
built on the host while round r runs where no phase needs the round's
global params and every phase is device-resident. Round checkpoints carry
the server state (``-server``), the top-k residuals (``-topk``) and the
privacy spend (``-dp.json``) beside the params.

A ``mesh`` (``parallel/mesh.py``, one rank per device) parallelizes the
round as the JAX engine's does: each ``client`` coordinate trains a
contiguous block of the round's sampled clients (uneven counts split
unevenly; the log keeps JAX's ``gspmd_client_pad_frac``), and the
accumulators' sums are all-reduced over ``client`` before the aggregate is
formed: DP noise is drawn once from the round seed after the reduction,
SecAgg's pairwise streams still cancel, the stochastic rounding of
compressed deltas draws each client's numbers where one device would, and
top-k residuals come back by client ID. Inside a client the batch rows
shard over ``data`` (one gradient all-reduce per step), ``zero1`` shards its
AdamW moments over ``data`` and ``tp`` its encoder matmuls over ``model``
(``parallel/layout.py``). Under a mesh the round data is staged, never
resident, as in JAX; the warm-starts and evaluations run whole on every
rank, and rank 0 logs and writes.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..data.collate import LengthBucketBatcher, _round_up
from ..data.dataset import AsrExample
from ..data.tokenizer import CTCCharTokenizer
from ..models.backbone import feat_extract_output_lengths
from ..models.config import DACSConfig
from ..models.recipes import get_recipe
from ..parallel import dist as pdist
from ..parallel.fed import (
    CompressedDeltaAccumulator,
    FedAvgAccumulator,
    SecAggAccumulator,
    TopKDeltaAccumulator,
    graft_network,
    select_network,
)
from ..serving.engine import resolve_device
from ..train.checkpoint import load_params, save_params
from ..train.logging import JsonlLogger
from ..train.optim import make_optimizer
from ..train.prefetch import prefetch_iter
from ..train.steps import (
    DeviceBatch,
    backbone_forward_fn,
    gather_hidden,
    make_hidden_train_step,
    make_multitask_train_step,
    make_train_step,
)
from ..train.train_state import create_train_state
from ..train.trainer import _DTYPES, Trainer, TrainerConfig
from .multitask import (
    attach_pseudo_labels,
    copy_first_head_to_lm_head,
    drop_lm_heads,
    generate_pseudo_labels,
    init_lm_heads_from_lm_head,
    make_pseudo_forward,
    nbest_stack,
)
from .privacy import DpAccountant

# stage -> aggregated sub-network (reference: stage1 aggregates "ASR"
# [encoder, lm_head] pairs, stage2 "AD", stage3 "toggling_network")
STAGE_NETWORK = {0: "ASR", 1: "AD", 2: "toggling_network"}


def _gather_batch(data: DeviceBatch, idx: torch.Tensor) -> DeviceBatch:
    """One training batch from a client's resident data by row indices;
    idx == -1 marks padding rows (zero lengths -> zero CTC frames -> zero
    loss, sample mask 0: the staged path's zero-padded rows)."""
    safe = idx.clamp(0, data.input_values.shape[0] - 1)
    mask = idx >= 0

    def keep(x, fill):
        g = x[safe]
        return torch.where(mask.view(-1, *([1] * (g.dim() - 1))), g, torch.full_like(g, fill))

    return DeviceBatch(
        input_values=data.input_values[safe],
        input_lengths=keep(data.input_lengths, 0),
        labels=keep(data.labels, -100),
        label_lengths=keep(data.label_lengths, 0),
        dementia_labels=keep(data.dementia_labels, 0),
        sample_mask=mask.float() * data.sample_mask[safe])


def _client_rows(data: DeviceBatch, k: int) -> DeviceBatch:
    """Client ``k``'s rows of the resident ``[K_total, N, ...]`` data."""
    return DeviceBatch(*(getattr(data, f.name)[k] for f in dataclasses.fields(data)))


@dataclass
class FederatedConfig:
    num_rounds: int = 10            # args.epochs
    num_clients: int = 2            # args.num_users
    frac: float = 1.0               # args.frac (client sampling fraction)
    local_ep: int = 5               # args.local_ep
    global_ep: int = 30             # args.global_ep (centralized warm-start)
    batch_size: int = 4
    eval_batch_size: int = 8
    seed: int = 0
    learning_rate: float | None = None   # None -> stage default
    warmup_steps: int = 1000
    weight_decay: float = 0.005
    compute_dtype: str = "float32"
    remat: bool = False             # recompute each encoder layer in backward
    time_multiple: int = 16000
    label_multiple: int = 32
    max_samples: int | None = None
    shuffle_window: int | None = None  # per-epoch batch-membership reshuffle
    log_file: str | None = None
    log_dir: str = "./saves/log"
    fedavg_weighted: bool = False   # reference uses an unweighted mean
    mesh: Any = None                # parallel.mesh.Mesh with a "client" axis
    # ZeRO-1 inside the round: each client's AdamW moments sharded over the
    # mesh's "data" axis (parallel/zero.py); needs a data axis >= 2
    zero1: bool = False
    # tensor parallelism inside each client over the mesh's "model" axis
    # (parallel/tp.py); needs a model axis >= 2
    tp: bool = False
    # keep client datasets resident on the device across rounds and send
    # only per-round index batches. None = auto: on under ~6 GB of padded
    # [K, n_max, t_max] audio
    resident_client_data: bool | None = None
    # 1 = supervised only; 0.5 = unsupervised (pseudo-labeled) phase then
    # supervised phase per round; 0 = unsupervised only
    supervised_level: float = 1.0
    # stage-1/2 rounds train the heads on cached encoder outputs (the frozen
    # backbone is deterministic there). False disables; past the budget a
    # source falls back to full forwards
    cache_encoder: bool | None = None
    cache_budget_bytes: int = 6 << 30
    # DP-FedAvg (parallel/fed.py dp_fedavg): clip each client's update delta
    # to this L2 norm and add Gaussian noise std = clip * noise_multiplier /
    # K to the aggregate. None = off. Unweighted aggregation only
    dp_clip_norm: float | None = None
    dp_noise_multiplier: float = 0.0
    dp_delta: float = 1e-5          # delta of the reported (epsilon, delta)
    # uplink compression: each client's round delta quantized to this many
    # bits (symmetric abs-max; stochastic rounding from a generator seeded
    # per round, or nearest). None = off. Exclusive with DP-FedAvg
    compress_bits: int | None = None
    compress_stochastic_rounding: bool = True
    # secure aggregation: deltas L2-clipped to this norm, quantized to
    # secagg_bits-bit integers and pairwise-masked. None = off. Unweighted
    secagg_clip_norm: float | None = None
    secagg_bits: int = 20
    # top-k sparsified FedAvg with per-client error-feedback residuals over
    # the stage's sub-network, kept per stage. None = off
    topk_fraction: float | None = None
    # FedProx: (mu/2)||w - w_round_start||^2 on each local objective
    fedprox_mu: float = 0.0
    # FedOpt: "none" = FedAvg, "momentum" = FedAvgM, "adam" = FedAdam, on
    # the negated round delta; server_lr None = 1.0 (momentum), 1e-2 (adam)
    server_optimizer: str = "none"
    server_lr: float | None = None
    server_momentum: float = 0.9
    # round checkpoints: the global params after every round_save_every-th
    # round under <round_save_dir>/stage{S}-round-{N}, resumed from the
    # newest of the stage on the next run_rounds call
    round_save_dir: str | None = None
    round_save_every: int = 1
    round_save_limit: int = 2       # like the reference's save_total_limit

    def __post_init__(self):
        if self.server_optimizer not in ("none", "momentum", "adam"):
            raise ValueError(f"server_optimizer must be none|momentum|adam, got "
                             f"{self.server_optimizer!r}")
        if self.compress_bits is not None and not 2 <= self.compress_bits <= 8:
            raise ValueError(f"compress_bits must be in [2, 8], got {self.compress_bits}")
        if self.compress_bits is not None and self.dp_clip_norm is not None:
            raise ValueError(
                "compress_bits and dp_clip_norm are mutually exclusive: "
                "quantize-before-clip vs clip-before-quantize changes the DP "
                "guarantee, so the combination must be an explicit choice "
                "(compose compressed_delta_fedavg/dp_fedavg directly)")
        modes = {"dp_clip_norm": self.dp_clip_norm, "compress_bits": self.compress_bits,
                 "secagg_clip_norm": self.secagg_clip_norm,
                 "topk_fraction": self.topk_fraction}
        on = [k for k, v in modes.items() if v is not None]
        if len(on) > 1:
            raise ValueError(
                f"aggregation modes are mutually exclusive, got {on}; the "
                "mask/clip/quantize/sparsify ordering of a composition is a "
                "privacy-accounting decision: compose the parallel/fed.py "
                "primitives directly if you need one")
        if self.secagg_clip_norm is not None:
            if not 2 <= self.secagg_bits <= 24:
                raise ValueError(f"secagg_bits must be in [2, 24], got {self.secagg_bits}")
            if self.fedavg_weighted:
                raise ValueError("secure aggregation is unweighted (per-client sample "
                                 "counts are private); disable fedavg_weighted")
        if self.topk_fraction is not None and not 0.0 < self.topk_fraction <= 1.0:
            raise ValueError(f"topk_fraction must be in (0, 1], got {self.topk_fraction}")
        if self.zero1 and (self.mesh is None or int(self.mesh.shape.get("data", 1)) < 2):
            raise ValueError(
                "zero1 shards per-client Adam moments over the 'data' mesh "
                "axis: set fcfg.mesh to a Mesh with a 'data' axis of size "
                ">= 2 (e.g. ('client', 'data') = (K, N/K))")
        if self.tp and (self.mesh is None or int(self.mesh.shape.get("model", 1)) < 2):
            raise ValueError(
                "tp Megatron-shards each client's encoder matmuls over the "
                "'model' mesh axis: set fcfg.mesh to a Mesh with a 'model' "
                "axis of size >= 2 (make_mesh(client=K, data=D, model=M))")
        if self.dp_noise_multiplier and self.dp_clip_norm is None:
            # noise std is clip * multiplier / K: without a clip norm there
            # is no DP at all
            raise ValueError("dp_noise_multiplier > 0 requires dp_clip_norm (the noise "
                             "std is clip * multiplier / K); set --dp_clip_norm")


class ServerOptimizer:
    """The FedOpt server optimizer on the stage's sub-network (``keys``): the
    negated round delta is the pseudo-gradient of optax ``sgd(lr,
    momentum)`` (FedAvgM) or ``adam(lr)`` (FedAdam), with optax's update
    rules; every other entry is left as the round left it (its delta is 0:
    graft keeps it)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, kind: str, lr: float, momentum: float, keys: Sequence[str]):
        self.kind, self.lr, self.momentum, self.keys = kind, lr, momentum, list(keys)
        self.count = 0
        self.slots: dict[str, dict[str, torch.Tensor]] = {}  # trace | mu, nu

    def step(self, old: Mapping[str, torch.Tensor],
             new: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        out = dict(new)
        self.count += 1
        names = ("mu", "nu") if self.kind == "adam" else ("trace",)
        for k in self.keys:
            g = -(new[k].float() - old[k].float())
            slot = self.slots.setdefault(k, {n: torch.zeros_like(g) for n in names})
            if self.kind == "adam":
                slot["mu"] = (1 - self.B1) * g + self.B1 * slot["mu"]
                slot["nu"] = (1 - self.B2) * g.square() + self.B2 * slot["nu"]
                mu_hat = slot["mu"] / (1 - self.B1 ** self.count)
                nu_hat = slot["nu"] / (1 - self.B2 ** self.count)
                update = -self.lr * (mu_hat / (nu_hat.sqrt() + self.EPS))
            else:
                if self.momentum:
                    slot["trace"] = g + self.momentum * slot["trace"]
                    g = slot["trace"]
                update = -self.lr * g
            out[k] = (old[k].float() + update).to(old[k].dtype)
        return out

    def state_dict(self) -> dict[str, torch.Tensor]:
        sd = {"count": torch.tensor(float(self.count))}
        for k, slot in self.slots.items():
            sd.update({f"{n}.{k}": v for n, v in slot.items()})
        return sd

    def load_state_dict(self, sd: Mapping[str, torch.Tensor], device) -> None:
        self.count = int(sd["count"])
        self.slots = {}
        for name, v in sd.items():
            if name != "count":
                n, k = name.split(".", 1)
                self.slots.setdefault(k, {})[n] = v.to(device, torch.float32)


class FederatedEngine:
    """``params``: the port's DACSModel state dict (models/port.py), held as
    fp32 on ``device`` in ``global_params`` (single-head: the N-best heads
    are per-client scratch inside a round). ``client_unsup_examples``: the
    per-client unlabeled (teacher-transcribed) data of the unsupervised
    phase (``supervised_level < 1``)."""

    def __init__(self, cfg: DACSConfig, fcfg: FederatedConfig,
                 client_examples: dict[Any, Sequence[AsrExample]],
                 public_examples: Sequence[AsrExample],
                 eval_examples: Sequence[AsrExample] | None,
                 tokenizer: CTCCharTokenizer, params: Mapping[str, torch.Tensor],
                 device: str | torch.device = "cuda",
                 client_unsup_examples: dict[Any, Sequence[AsrExample]] | None = None):
        if cfg.method != "dacs":
            # the reference's FL pipeline exists for the DACS model only
            raise ValueError(f"the federated engine drives the DACS method only, got "
                             f"method={cfg.method!r}")
        self.device = pdist.init_distributed(resolve_device(device))
        self.cfg, self.fcfg = cfg, fcfg
        self.layout, self.client_group = self._make_layout(cfg, fcfg)
        self.lead = pdist.rank() == 0
        self.client_ids = sorted(client_examples.keys(), key=str)
        self.client_examples = client_examples
        self.client_unsup_examples = client_unsup_examples or {}
        self.public_examples = public_examples
        self.eval_examples = eval_examples
        self.tokenizer = tokenizer
        self.global_params = {k: v.detach().to(self.device, torch.float32).clone()
                              for k, v in params.items()}
        self.logger = JsonlLogger(fcfg.log_dir, fcfg.log_file if self.lead else None,
                                  echo=self.lead)
        self._model = None     # the one model the clients train in turn
        self._mt_model = None  # with the N-best heads (num_lms > 1)
        self._pseudo_fwd = make_pseudo_forward(cfg.replace(num_lms=1))
        # stage -> FedOpt server state; stage -> per-client top-k residuals
        # {key: [K_total, ...]} over the stage's sub-network
        self._server_opts: dict[int, ServerOptimizer] = {}
        self._topk_residuals: dict[int, dict[str, torch.Tensor]] = {}
        self._eval_trainers: dict[int, Trainer] = {}
        self._last_dead_step_frac = 0.0  # padding overhead of the last round
        self._resident_cache: dict = {}  # id(source) -> (data_all, batchers, ids, source)
        # id(source) -> (h_all, fl_all) frozen-backbone encoder-output cache;
        # persists across run_rounds calls, cleared when stage-0 training
        # mutates the backbone
        self._round_hidden: dict = {}
        self._hidden_over_budget: set = set()  # sources too big to cache
        # RDP accountant for DP-FedAvg rounds, stepped once per noised round,
        # composed across stages, checkpointed as a '-dp.json' round sidecar
        self._dp_accountant = DpAccountant(delta=fcfg.dp_delta)

    def _make_layout(self, cfg: DACSConfig, f: FederatedConfig):
        """The round's layout inside a client (data / model axes) and the
        group of the client axis; (None, None) without a mesh."""
        mesh = f.mesh
        if mesh is None:
            return None, None
        if f.tp:
            from ..parallel.tp import validate_tp_divisibility

            validate_tp_divisibility(cfg.backbone, int(mesh.shape["model"]))
        data_n = int(mesh.shape.get("data", 1))
        if data_n > 1 and f.batch_size % data_n:
            raise ValueError(
                f"batch_size ({f.batch_size}) must be divisible by "
                f"the data mesh axis ({data_n}) so each client's batch rows "
                "shard evenly across its data devices")
        if f.resident_client_data:
            raise ValueError(
                "resident_client_data=True is not supported with a mesh "
                "(the staged path keeps client-axis data locality there); "
                "leave it None/False when fcfg.mesh is set")
        if mesh.size != pdist.world_size():
            raise ValueError(f"mesh of {mesh.size} ranks in a world of {pdist.world_size()} "
                             "(launch one rank per mesh device)")
        mesh.bind("cuda" if pdist.backend_for(self.device) == "nccl" else "cpu")
        from ..parallel.layout import Layout

        layout = (Layout(mesh, cfg, zero1=f.zero1)
                  if data_n > 1 or mesh.axis_size("model") > 1 else None)
        return layout, (mesh.group("client") if mesh.axis_size("client") > 1 else None)

    def _make_model(self, num_lms: int):
        with torch.device("meta"):
            model = get_recipe(self.cfg.method).make_model(
                self.cfg.replace(num_lms=num_lms), _DTYPES[self.fcfg.compute_dtype],
                torch.float32, self.fcfg.remat)
        model = model.to_empty(device=self.device)
        if self.layout is not None:  # shards need the whole state first
            g = self.global_params
            model.load_state_dict(g if num_lms == 1 else init_lm_heads_from_lm_head(g, num_lms))
            self.layout.attach(model)
        return model

    @property
    def model(self):
        """The engine's model instance (single-head, compute dtype, fp32
        params)."""
        if self._model is None:
            self._model = self._make_model(1)
        return self._model

    @property
    def mt_model(self):
        """The N-best multitask model of the ``mt`` phases."""
        if self._mt_model is None:
            self._mt_model = self._make_model(self.cfg.num_lms)
        return self._mt_model

    def _load_global(self):
        if self.layout is None:
            self.model.load_state_dict(self.global_params, strict=True)
        else:
            self.layout.load_state_dict(self.model, self.global_params)
        return self.model

    def _client_params(self) -> dict[str, torch.Tensor]:
        """The trained client's whole params (collective under tp)."""
        model = self.model
        return model.state_dict() if self.layout is None else self.layout.state_dict(model)

    def _my_clients(self, m: int) -> range:
        """This rank's block of the round's ``m`` sampled clients."""
        if self.client_group is None:
            return range(m)
        from ..parallel.mesh import block

        return block(m, pdist.group_size(self.client_group),
                     pdist.group_rank(self.client_group))

    # ------------------------------------------------------------------
    # data: per-client step streams
    # ------------------------------------------------------------------

    def _client_round_batches(self, cids, round_idx: int, source: dict,
                              pseudo: dict | None = None) -> list:
        """Staged data of one round: per client a list of DeviceBatches,
        every client padded to the round's largest step count with
        all-masked batches and every batch to the round's (T, L).
        ``pseudo`` (cid -> path -> N-best (text, ids, conf)) marks the
        N-best multitask phase: the examples carry their 1-best labels for
        the bucketing, and each step is ``(DeviceBatch, labels_stack [N, B,
        L], lengths [N, B])``."""
        f = self.fcfg
        n_lms = self.cfg.num_lms
        per_client, t_max, l_max = [], 0, 0
        for cid in cids:
            examples = source[cid]
            if pseudo is not None:
                examples = attach_pseudo_labels(examples, pseudo[cid])
            batcher = LengthBucketBatcher(
                examples, f.batch_size, time_multiple=f.time_multiple,
                label_multiple=f.label_multiple, seed=f.seed + round_idx,
                max_samples=f.max_samples, shuffle_window=f.shuffle_window)
            batches = []
            for ep in range(f.local_ep):
                batches.extend(batcher.epoch(epoch_seed=f.seed + 1000 * round_idx + ep))
            per_client.append(batches)
            t_max = max(t_max, max(b.input_values.shape[1] for b in batches))
            l_max = max(l_max, max(b.labels.shape[1] for b in batches))
            if pseudo is not None:  # N-best sets can be longer than 1-best
                l_max = max([l_max] + [len(ids) for b in batches for p in b.paths
                                       for _, ids, _ in pseudo[cid][p][:n_lms]])
        if pseudo is not None:
            l_max = _round_up(l_max, f.label_multiple)
        steps = self._last_steps = max(len(bs) for bs in per_client)
        self._last_dead_step_frac = 1.0 - sum(map(len, per_client)) / (steps * len(cids))

        def pad_to(b):
            iv = np.zeros((b.input_values.shape[0], t_max), np.float32)
            iv[:, : b.input_values.shape[1]] = b.input_values
            lab = np.full((b.labels.shape[0], l_max), -100, np.int32)
            lab[:, : b.labels.shape[1]] = b.labels
            return dataclasses.replace(b, input_values=iv, labels=lab)

        out = []
        mine = set(self._my_clients(len(cids)))
        for ki, (cid, batches) in enumerate(zip(cids, per_client)):
            if ki not in mine:  # another client rank trains it
                out.append(None)
                continue
            dev = [DeviceBatch.from_host(pad_to(b), self.device) for b in batches]
            while len(dev) < steps:  # pad with an all-masked batch
                dummy = DeviceBatch(*(torch.zeros_like(x) for x in dataclasses.astuple(dev[0])))
                dummy.labels.fill_(-100)
                dev.append(dummy)
            if pseudo is not None:
                stacks = [tuple(torch.from_numpy(x).to(self.device) for x in nbest_stack(
                    b.paths, pseudo[cid], n_lms, f.batch_size, l_max)) for b in batches]
                while len(stacks) < len(dev):
                    stacks.append((torch.full_like(stacks[0][0], -100),
                                   torch.zeros_like(stacks[0][1])))
                dev = [(db, lab, ll) for db, (lab, ll) in zip(dev, stacks)]
            out.append(dev)
        return out

    def _resident_enabled(self, source: dict) -> bool:
        f = self.fcfg
        if f.mesh is not None:  # staged under a mesh, as in JAX
            return False
        if f.resident_client_data is not None:
            return f.resident_client_data
        # auto: cap the footprint of the DENSE-PADDED [K, n_max, t_max]
        # resident array (far larger than the raw audio bytes when client
        # sizes or utterance lengths are skewed)
        def used(exs):
            return [e for e in exs
                    if f.max_samples is None or len(e.input_values) <= f.max_samples]

        lens = [len(e.input_values) for exs in source.values() for e in used(exs)]
        if not lens:
            return False
        t_max = _round_up(max(lens), f.time_multiple)
        n_max = max(len(used(exs)) for exs in source.values())
        return 4 * len(source) * n_max * t_max < 6e9

    def _ensure_resident(self, source: dict):
        """Every client's whole (filtered, length-sorted) dataset as stacked
        ``[K_total, N, ...]`` device tensors, uploaded once; later rounds
        send only index batches."""
        key = id(source)
        if key in self._resident_cache:
            return self._resident_cache[key]
        f = self.fcfg
        ids = sorted(source.keys(), key=str)
        batchers = {cid: LengthBucketBatcher(
            source[cid], f.batch_size, time_multiple=f.time_multiple,
            label_multiple=f.label_multiple, seed=f.seed, max_samples=f.max_samples,
            shuffle_window=f.shuffle_window) for cid in ids}
        all_exs = [e for b in batchers.values() for e in b.examples]
        t_max = _round_up(max(len(e.input_values) for e in all_exs), f.time_multiple)
        l_max = _round_up(max(len(e.labels) for e in all_exs), f.label_multiple)
        n_max = max(len(b.examples) for b in batchers.values())
        k = len(ids)
        iv = np.zeros((k, n_max, t_max), np.float32)
        il = np.zeros((k, n_max), np.int32)
        lab = np.full((k, n_max, l_max), -100, np.int32)
        ll = np.zeros((k, n_max), np.int32)
        dem = np.zeros((k, n_max), np.int32)
        sm = np.zeros((k, n_max), np.float32)
        for ki, cid in enumerate(ids):
            for j, e in enumerate(batchers[cid].examples):
                iv[ki, j, : len(e.input_values)] = e.input_values
                il[ki, j] = len(e.input_values)
                lab[ki, j, : len(e.labels)] = e.labels
                ll[ki, j] = len(e.labels)
                dem[ki, j] = e.dementia_label
                sm[ki, j] = 1.0
        data_all = DeviceBatch(*(torch.from_numpy(x).to(self.device)
                                 for x in (iv, il, lab, ll, dem, sm)))
        # the source dict itself is kept in the value so the id() key can
        # never be recycled while the cache entry lives
        self._resident_cache[key] = (data_all, batchers, ids, source)
        return self._resident_cache[key]

    def _client_round_indices(self, cids, round_idx: int, source: dict):
        """One round's batch compositions as ``[m, steps, B]`` indices into
        the resident data (-1 = padding), same epoch seeds and order as the
        staged path; returns (data_all, row of each sampled client, idx)."""
        data_all, batchers, ids, _ = self._ensure_resident(source)
        f = self.fcfg
        per = []
        for cid in cids:
            groups: list[list[int]] = []
            for ep in range(f.local_ep):
                groups.extend(batchers[cid].epoch_indices(
                    epoch_seed=f.seed + 1000 * round_idx + ep))
            per.append(groups)
        steps = max(len(g) for g in per)
        self._last_dead_step_frac = 1.0 - sum(map(len, per)) / (steps * len(per))
        arr = np.full((len(cids), steps, f.batch_size), -1, np.int64)
        for ki, groups in enumerate(per):
            for s, g in enumerate(groups):
                arr[ki, s] = g
        return data_all, [ids.index(c) for c in cids], torch.from_numpy(arr).to(self.device)

    def _hidden_cache_for(self, stage: int, source: dict):
        """Encoder outputs ``[K_total, N, T', D]`` of every resident
        utterance of ``source``, computed ONCE with the current global
        params: in stages 1/2 the encoder is frozen, deterministic and
        outside the aggregated sub-network, so the cache holds across
        ``run_rounds`` calls until stage-0 training mutates the backbone.
        None when disabled or over ``cache_budget_bytes``. Built in chunks
        of ``eval_batch_size`` rows, the tail chunk a full-size window."""
        key = id(source)
        hc = self._round_hidden.get(key)
        if hc is not None:
            return hc
        f = self.fcfg
        if f.cache_encoder is False or key in self._hidden_over_budget:
            return None
        data_all, _, _, _ = self._ensure_resident(source)
        k_total, n, t_audio = data_all.input_values.shape
        chunk = max(min(f.eval_batch_size, n), 1)
        t_frames = feat_extract_output_lengths(self.cfg.backbone, t_audio)
        dt = _DTYPES[f.compute_dtype]
        need = k_total * n * t_frames * self.cfg.hidden_size * dt.itemsize
        if need > f.cache_budget_bytes:
            print(f"[engine] hidden cache ({need / 1e9:.1f} GB) over budget "
                  f"({f.cache_budget_bytes / 1e9:.1f} GB); stage-1/2 rounds fall back "
                  "to full forwards for this source")
            self._hidden_over_budget.add(key)
            return None
        t0 = time.perf_counter()
        fwd = backbone_forward_fn(self._load_global())
        h_all = torch.empty((k_total, n, t_frames, self.cfg.hidden_size), dtype=dt,
                            device=self.device)
        fl_all = torch.empty((k_total, n), dtype=torch.int64, device=self.device)
        forwards = 0
        for ki in range(k_total):
            for i in range(0, n, chunk):
                j = min(i + chunk, n)
                s = j - chunk if j - i < chunk else i  # full-size tail window
                h, fl = fwd(data_all.input_values[ki, s: s + chunk],
                            data_all.input_lengths[ki, s: s + chunk])
                h_all[ki, i:j], fl_all[ki, i:j] = h[i - s:], fl[i - s:]
                forwards += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._round_hidden[key] = (h_all, fl_all)
        self.logger.log({"stage": stage, "hidden_cache_s": time.perf_counter() - t0,
                         "hidden_cache_forwards": forwards,
                         "hidden_cache_rows": k_total * n})
        return self._round_hidden[key]

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------

    def _round_pseudo_labels(self, cids, stage: int, rnd: int) -> dict:
        """Per-client N-best pseudo transcripts from the CURRENT global model
        (the reference regenerates them at every local update with the
        round-start weights, gen_Ntranscripts)."""
        f = self.fcfg
        model = self._load_global()
        return {cid: generate_pseudo_labels(
            self.cfg.replace(stage=stage, num_lms=1), model,
            self.client_unsup_examples[cid], self.tokenizer, self.cfg.num_lms,
            batch_size=f.batch_size, time_multiple=f.time_multiple, seed=f.seed + rnd,
            forward_fn=self._pseudo_fwd) for cid in cids}

    def _build_round(self, stage: int, rnd: int, cids) -> tuple:
        """Host-side data build for one round: (phases, specs, dead_frac).
        With ``supervised_level < 1`` the unsupervised phase comes first:
        plain CTC on the unlabeled data's own transcripts, or the N-best
        multitask phase (``mt``) on pseudo labels of the current global
        model (``num_lms > 1``); then, unless ``supervised_level == 0``,
        the supervised phase."""
        sl = self.fcfg.supervised_level
        phases, specs, dead_fracs = [], [], []
        if sl < 1.0:
            if self.cfg.num_lms > 1:
                pseudo = self._round_pseudo_labels(cids, stage, rnd)
                data = self._client_round_batches(cids, rnd, self.client_unsup_examples,
                                                  pseudo)
                phases.append(data)
                specs.append(("mt", self._last_steps))
            else:
                phase, spec = self._resident_or_staged_phase(
                    stage, self.client_unsup_examples, cids, rnd)
                phases.append(phase)
                specs.append(spec)
            dead_fracs.append(self._last_dead_step_frac)
        if sl > 0.0:
            phase, spec = self._resident_or_staged_phase(stage, self.client_examples, cids,
                                                         rnd)
            phases.append(phase)
            specs.append(spec)
            dead_fracs.append(self._last_dead_step_frac)
        # the worst phase's padding overhead
        return tuple(phases), tuple(specs), max(dead_fracs, default=0.0)

    def _resident_or_staged_phase(self, stage: int, source: dict, cids, rnd: int):
        """One supervised phase: cached-encoder (``res_h``) when a hidden
        cache exists for ``source`` and the stage's backbone is frozen
        (1/2), else resident indices (``res``), else staged (``sup``)."""
        if self._resident_enabled(source):
            data_all, rows, idx = self._client_round_indices(cids, rnd, source)
            hc = self._round_hidden.get(id(source)) if stage in (1, 2) else None
            if hc is not None:
                return (*hc, data_all, rows, idx), ("res_h", idx.shape[1])
            return (data_all, rows, idx), ("res", idx.shape[1])
        data = self._client_round_batches(cids, rnd, source)
        return data, ("sup", self._last_steps)

    def _client_seed(self, rnd: int, ki: int, phase: int) -> int:
        """Seed of the random streams of the ``ki``-th sampled client's
        ``phase`` in round ``rnd`` (dropout, Gumbel noise)."""
        return (self.fcfg.seed + 7919 * rnd) * 1_000_003 + 97 * ki + phase

    @staticmethod
    def _phase_batches(kind: str, phase, ki: int):
        """The ``ki``-th sampled client's batches of one phase, one per step."""
        if kind in ("sup", "mt"):
            return iter(phase[ki])
        if kind == "res":
            data_all, rows, idx = phase
            data = _client_rows(data_all, rows[ki])
            return (_gather_batch(data, i) for i in idx[ki])
        h_all, fl_all, data_all, rows, idx = phase
        r = rows[ki]
        data = _client_rows(data_all, r)
        return (gather_hidden(h_all[r], fl_all[r], data.labels, data.label_lengths,
                              data.dementia_labels, i, row_mask=data.sample_mask)
                for i in idx[ki])

    def _local_train(self, stage: int, rnd: int, ki: int, phases, specs) -> torch.Tensor:
        """Client ``ki``'s local training from the global params, in place
        on the engine's model; returns its losses, one per step. Each phase
        gets a fresh optimizer; FedProx anchors every phase on the
        round-start global params. An ``mt`` phase trains the N-best model
        from the current params with its heads set from lm_head, and hands
        its first head back as lm_head."""
        f = self.fcfg
        cfg = self.cfg.replace(stage=stage, num_lms=1)
        model = self._load_global()
        losses = []
        for p, ((kind, steps), phase) in enumerate(zip(specs, phases)):
            anchor, train_model = self.global_params, model
            if kind == "mt":
                n = self.cfg.num_lms
                train_model = self.mt_model
                train_model.load_state_dict(init_lm_heads_from_lm_head(model.state_dict(), n))
                anchor = init_lm_heads_from_lm_head(self.global_params, n)
            tx = make_optimizer(train_model, stage, f.learning_rate, f.weight_decay,
                                warmup_steps=f.warmup_steps, total_steps=max(steps, 1),
                                fedprox_mu=f.fedprox_mu, prox_ref=anchor, layout=self.layout)
            state = create_train_state(train_model, tx, self._client_seed(rnd, ki, p))
            if kind == "mt":
                step = make_multitask_train_step(self.cfg.replace(stage=stage))
                for element in self._phase_batches(kind, phase, ki):
                    losses.append(step(state, *element)["loss"])
                model.load_state_dict(drop_lm_heads(copy_first_head_to_lm_head(
                    train_model.state_dict())))
                continue
            step = make_hidden_train_step(cfg) if kind == "res_h" else make_train_step(cfg)
            for batch in self._phase_batches(kind, phase, ki):
                losses.append(step(state, batch)["loss"])
        return torch.stack(losses)

    def _run_round(self, stage: int, rnd: int, cids, phases, specs) -> list[float]:
        """Every sampled client in turn, the round's aggregate of the
        stage's sub-network (FedAvg, DP-FedAvg, compressed, secure or top-k),
        graft into the global params, then the server optimizer's step;
        returns each client's mean step loss."""
        f = self.fcfg
        network = STAGE_NETWORK[stage]
        g = self.global_params
        keys = list(select_network(g, network))
        m = len(cids)
        weights = [len(self.client_examples[c]) for c in cids] if f.fedavg_weighted else None
        round_seed = (f.seed + 7919 * rnd) * 1_000_003
        pos = None
        if f.dp_clip_norm is not None:
            gen = torch.Generator(self.device).manual_seed(round_seed + 0x5A11)
            acc = FedAvgAccumulator(keys, m, global_params=g, clip_norm=f.dp_clip_norm,
                                    noise_multiplier=f.dp_noise_multiplier, generator=gen)
        elif f.compress_bits is not None:
            gen = (torch.Generator(self.device).manual_seed(round_seed + 0xC0)
                   if f.compress_stochastic_rounding else None)
            acc = CompressedDeltaAccumulator(keys, m, g, f.compress_bits, gen, weights)
        elif f.secagg_clip_norm is not None:
            acc = SecAggAccumulator(keys, m, g, f.secagg_clip_norm, round_seed + 0x5EC,
                                    f.secagg_bits)
        elif f.topk_fraction is not None:
            # residuals are per client ID; the round sees the sampled
            # clients' rows in sample order, scattered back afterwards
            res_all = self._topk_residuals_for(stage)
            pos = [self.client_ids.index(c) for c in cids]
            acc = TopKDeltaAccumulator(keys, m, g, f.topk_fraction,
                                       [{k: res_all[k][i] for k in keys} for i in pos],
                                       weights)
        else:
            acc = FedAvgAccumulator(keys, m, weights)
        mine = self._my_clients(m)
        if mine.start and f.compress_bits is not None:
            acc.skip_draws(mine.start)  # the earlier clients' rounding draws
        losses = torch.zeros(m, device=self.device)
        for ki in mine:
            losses[ki] = self._local_train(stage, rnd, ki, phases, specs).mean()
            acc.add(self._client_params(), ki)
        if self.client_group is not None:
            acc.all_reduce(self.client_group, g)
            pdist.all_reduce_(losses, self.client_group)
        new_global = graft_network(g, acc.result(), network)
        if pos is not None:
            for k in keys:
                rows = torch.zeros((m, *g[k].shape), device=self.device)
                for j, ki in enumerate(mine):
                    rows[ki] = acc.residuals[j][k]
                if self.client_group is not None:
                    pdist.all_reduce_(rows, self.client_group)
                for ki, i in enumerate(pos):
                    res_all[k][i] = rows[ki]
        server = self._server_opt(stage)
        if server is not None:
            new_global = server.step(g, new_global)
        self.global_params = new_global
        return [float(x) for x in losses]

    def _server_opt(self, stage: int) -> ServerOptimizer | None:
        """The stage's FedOpt server optimizer, made at its first round
        (each stage aggregates another sub-network: no momentum crosses
        stages); None for FedAvg."""
        f = self.fcfg
        if f.server_optimizer == "none":
            return None
        if stage not in self._server_opts:
            lr = f.server_lr if f.server_lr is not None else (
                1.0 if f.server_optimizer == "momentum" else 1e-2)
            self._server_opts[stage] = ServerOptimizer(
                f.server_optimizer, lr, f.server_momentum,
                list(select_network(self.global_params, STAGE_NETWORK[stage])))
        return self._server_opts[stage]

    def _topk_residuals_for(self, stage: int) -> dict[str, torch.Tensor]:
        """The stage's error-feedback residuals ``{key: [K_total, ...]}``
        over its sub-network, zeros at first (one fp32 copy of the
        sub-network per client: the algorithm's memory cost)."""
        if stage not in self._topk_residuals:
            k_total = len(self.client_ids)
            self._topk_residuals[stage] = {
                k: torch.zeros((k_total, *v.shape), dtype=torch.float32, device=self.device)
                for k, v in select_network(self.global_params, STAGE_NETWORK[stage]).items()}
        return self._topk_residuals[stage]

    # ------------------------------------------------------------------
    # round checkpoints
    # ------------------------------------------------------------------

    def _round_ckpts(self, stage: int) -> list[tuple[int, Path]]:
        """Sorted (round, path) list of this stage's round checkpoints,
        namespaced per stage (``stage{S}-round-{N}``)."""
        pat = re.compile(rf"^stage{stage}-round-(\d+)$")
        out = []
        for p in Path(self.fcfg.round_save_dir).glob(f"stage{stage}-round-*"):
            m = pat.match(p.name)
            if m is not None:
                out.append((int(m.group(1)), p))
        return sorted(out)

    def _maybe_save_round(self, stage: int, rnd: int) -> None:
        f = self.fcfg
        if f.round_save_dir is None or rnd % max(f.round_save_every, 1) or not self.lead:
            return
        p = save_params(Path(f.round_save_dir) / f"stage{stage}-round-{rnd}",
                        self.global_params, {"stage": stage, "round": rnd})
        if stage in self._server_opts:
            save_params(p.with_name(p.name + "-server"),
                        self._server_opts[stage].state_dict())
        if stage in self._topk_residuals:
            save_params(p.with_name(p.name + "-topk"), self._topk_residuals[stage])
        if self._dp_active():
            p.with_name(p.name + "-dp.json").write_text(
                json.dumps(self._dp_accountant.state_dict()))
        ckpts = self._round_ckpts(stage)
        for _, old in ckpts[: max(0, len(ckpts) - f.round_save_limit)]:
            shutil.rmtree(old)
            for suffix in ("-server", "-topk"):
                shutil.rmtree(old.with_name(old.name + suffix), ignore_errors=True)
            old.with_name(old.name + "-dp.json").unlink(missing_ok=True)

    def _maybe_resume_rounds(self, stage: int) -> int:
        """Load this stage's newest round checkpoint (if configured);
        returns the number of rounds already completed."""
        f = self.fcfg
        if f.round_save_dir is None:
            return 0
        ckpts = self._round_ckpts(stage)
        if not ckpts:
            return 0
        rnd, p = ckpts[-1]
        self.global_params = {k: v.to(self.device, torch.float32)
                              for k, v in load_params(p).items()}
        server = self._server_opt(stage)
        if server is not None:
            srv = p.with_name(p.name + "-server")
            if srv.exists():
                server.load_state_dict(load_params(srv), self.device)
            else:
                # resuming without the momentum makes the continued run
                # differ from the straight-through one
                print(f"[engine] round checkpoint {p.name} has no '-server' sibling; "
                      f"{f.server_optimizer} server state restarts from zero (resume is "
                      "inexact)")
                self.logger.log({"fl_resume_server_state_missing": 1.0, "stage": stage})
        if f.topk_fraction is not None:
            tk = p.with_name(p.name + "-topk")
            if tk.exists():
                self._topk_residuals[stage] = {k: v.to(self.device, torch.float32)
                                               for k, v in load_params(tk).items()}
            else:
                # zeros would silently drop every untransmitted coordinate
                print(f"[engine] round checkpoint {p.name} has no '-topk' sibling; top-k "
                      "error-feedback residuals restart from zero (resume is inexact)")
                self.logger.log({"fl_resume_topk_residuals_missing": 1.0, "stage": stage})
        if self._dp_active():
            dp = p.with_name(p.name + "-dp.json")
            if dp.exists():
                self._dp_accountant = DpAccountant.from_state(json.loads(dp.read_text()))
            else:
                # reconstruct this stage's spend exactly (q and sigma are
                # constant within a run); other stages' rounds are lost
                self._dp_accountant.step(self._dp_q(), f.dp_noise_multiplier, num_steps=rnd)
                print(f"[engine] round checkpoint {p.name} has no '-dp.json' sidecar; "
                      f"the privacy accountant was rebuilt from this stage's {rnd} "
                      "rounds only — epsilon excludes rounds other stages ran "
                      "before the restart")
                self.logger.log({"fl_resume_dp_accountant_rebuilt": 1.0, "stage": stage})
        self.logger.log({"fl_resume_round": rnd, "stage": stage})
        return rnd

    def _dp_active(self) -> bool:
        f = self.fcfg
        return f.dp_clip_norm is not None and f.dp_noise_multiplier > 0.0

    def _dp_q(self) -> float:
        """Per-round client sampling rate m/K for the RDP accountant."""
        k_total = len(self.client_ids)
        return max(int(self.fcfg.frac * k_total), 1) / k_total

    # ------------------------------------------------------------------
    # host loops
    # ------------------------------------------------------------------

    def run_rounds(self, stage: int, num_rounds: int | None = None) -> dict:
        """FedAvg rounds (reference FL_training_rounds,
        federated_main.py:69-145). The client plan comes from
        ``np.random.default_rng(seed)`` once per call, so a resumed run
        sees the same plan. Round r+1 is built on the host (``prefetch_iter``,
        depth 1) while round r runs, where no phase needs the current
        global params (``num_lms == 1``) and every phase's data is
        device-resident (staged rounds would keep several rounds of client
        audio live)."""
        f = self.fcfg
        if f.dp_clip_norm is not None and f.fedavg_weighted:
            raise ValueError("DP-FedAvg is unweighted (uniform-contribution "
                             "accounting); disable fedavg_weighted")
        num_rounds = f.num_rounds if num_rounds is None else num_rounds
        rng = np.random.default_rng(f.seed)
        k_total = len(self.client_ids)
        m = max(int(f.frac * k_total), 1)
        plan = [(rnd, [self.client_ids[i] for i in rng.choice(k_total, size=m, replace=False)])
                for rnd in range(num_rounds)]
        sl = f.supervised_level
        sources = (([self.client_unsup_examples] if sl < 1.0 and self.cfg.num_lms == 1
                    else []) + ([self.client_examples] if sl > 0.0 else []))
        # stages 1/2: the frozen deterministic encoder's output of every
        # utterance is computed once; the rounds train heads on it
        if stage in (1, 2):
            for src in sources:
                if self._resident_enabled(src):
                    self._hidden_cache_for(stage, src)
        start_round = self._maybe_resume_rounds(stage)
        if start_round >= num_rounds:
            return self.global_params
        t0 = time.perf_counter()
        built = ((rnd, cids, self._build_round(stage, rnd, cids))
                 for rnd, cids in plan[start_round:])
        if self.cfg.num_lms == 1 and all(map(self._resident_enabled, sources)):
            built = prefetch_iter(built, depth=1)
        for rnd, cids, (phases, specs, dead_frac) in built:
            losses = self._run_round(stage, rnd, cids, phases, specs)
            row = {"fl_round": rnd + 1, "stage": stage,
                   "clients": ",".join(str(c) for c in cids),
                   "dead_step_frac": round(dead_frac, 4),
                   **{f"client{c}_loss": loss for c, loss in zip(cids, losses)},
                   "local_steps": m * sum(s for _, s in specs),
                   "phase": "+".join(kind for kind, _ in specs),
                   "phase_steps": "+".join(str(s) for _, s in specs),
                   "round_s": time.perf_counter() - t0}
            if self._dp_active():
                self._dp_accountant.step(m / k_total, f.dp_noise_multiplier)
                row["dp_epsilon"] = round(self._dp_accountant.epsilon(), 4)
                row["dp_delta"] = f.dp_delta
            if f.mesh is not None:
                # JAX's GSPMD pads an uneven client dim (those lanes train
                # on nothing); here the block split is uneven instead, and
                # the row keeps JAX's record of the idle share
                c_ax = int(f.mesh.shape["client"])
                if m % c_ax:
                    padded = -(-m // c_ax) * c_ax
                    row["gspmd_client_pad_frac"] = round(1.0 - m / padded, 4)
            self.logger.log(row)
            if self.eval_examples is not None:
                ev = self.evaluate(stage)
                ev.update({"fl_round": rnd + 1, "stage": stage})
                self.logger.log(ev)
            self._maybe_save_round(stage, rnd + 1)
            t0 = time.perf_counter()
        if stage == 0:  # the rounds trained the backbone: hidden caches stale
            self._invalidate_hidden_caches()
        return self.global_params

    def _invalidate_hidden_caches(self) -> None:
        """Drop every frozen-backbone encoder-output cache (the engine's
        round caches and the eval Trainers' hidden eval caches): called
        after any stage-0 training, the only place the backbone mutates."""
        self._round_hidden.clear()
        for tr in self._eval_trainers.values():
            tr._hidden = None
            tr._hidden_eval = None

    def centralized_training(self, stage: int, num_epochs: int | None = None) -> dict:
        """Global warm-start on the public split (reference
        centralized_training -> ASRGlobalUpdate.update_weights)."""
        f = self.fcfg
        t0 = time.perf_counter()
        tr = Trainer(
            self.cfg.replace(stage=stage, num_lms=1), self.global_params,
            self.public_examples,
            self.eval_examples, self.tokenizer,
            TrainerConfig(
                num_epochs=f.global_ep if num_epochs is None else num_epochs,
                batch_size=f.batch_size, eval_batch_size=f.eval_batch_size,
                learning_rate=f.learning_rate, warmup_steps=f.warmup_steps,
                weight_decay=f.weight_decay, compute_dtype=f.compute_dtype,
                remat=f.remat, time_multiple=f.time_multiple,
                label_multiple=f.label_multiple, max_samples=f.max_samples,
                shuffle_window=f.shuffle_window, seed=f.seed, log_dir=f.log_dir,
                log_file=f.log_file and f"global_{f.log_file}"),
            device=self.device)
        tr.train()
        self.global_params = {k: v.detach().float().clone()
                              for k, v in tr.state.model.state_dict().items()}
        self.logger.log({"stage": stage, "warm_start_steps": tr.state.step,
                         "warm_start_s": time.perf_counter() - t0,
                         "train_cache_s": sum(r["cache_s"] for r in tr.logger.history
                                              if "cache_s" in r)})
        if stage == 0:  # backbone trained: hidden caches stale
            self._invalidate_hidden_caches()
        return self.global_params

    def evaluate(self, stage: int) -> dict:
        """One Trainer per stage, reused across rounds (its eval batches, or
        at stages 1/2 its hidden eval cache, stay on the device)."""
        tr = self._eval_trainers.get(stage)
        if tr is None:
            f = self.fcfg
            tr = Trainer(self.cfg.replace(stage=stage, num_lms=1), self.global_params, [],
                         self.eval_examples, self.tokenizer,
                         TrainerConfig(batch_size=f.eval_batch_size,
                                       eval_batch_size=f.eval_batch_size,
                                       time_multiple=f.time_multiple,
                                       label_multiple=f.label_multiple),
                         device=self.device)
            self._eval_trainers[stage] = tr
        tr.state.model.load_state_dict(self.global_params, strict=True)
        return tr.evaluate()

    # ---- the 3-stage DACS FL pipeline ----

    def run_stage1(self) -> dict:
        """ASR fine-tune: centralized warm-start + FL rounds, aggregate ASR
        (reference stage1_training, federated_main.py:148-167)."""
        self.centralized_training(stage=0)
        return self.run_rounds(stage=0)

    def run_stage2(self) -> dict:
        """AD classifier (reference stage2_training :169-182)."""
        self.centralized_training(stage=1)
        return self.run_rounds(stage=1)

    def run_stage3(self) -> dict:
        """Toggling network (reference stage3_training :184-205)."""
        self.centralized_training(stage=2)
        return self.run_rounds(stage=2)

    def run_full_pipeline(self) -> dict:
        self.run_stage1()
        self.run_stage2()
        self.run_stage3()
        return self.global_params
