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
public split + FL rounds + graft of the aggregated sub-network. DP-FedAvg
(``dp_clip_norm``, ``dp_noise_multiplier``) with its RDP accountant is
ported; the options listed in :func:`_check_ported` are not yet and raise
``NotImplementedError``.
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
from ..parallel.fed import FedAvgAccumulator, graft_network, select_network
from ..serving.engine import resolve_device
from ..train.checkpoint import load_params, save_params
from ..train.logging import JsonlLogger
from ..train.optim import make_optimizer
from ..train.steps import (
    DeviceBatch,
    backbone_forward_fn,
    gather_hidden,
    make_hidden_train_step,
    make_train_step,
)
from ..train.train_state import create_train_state
from ..train.trainer import _DTYPES, Trainer, TrainerConfig
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
    remat: bool = False             # not ported (the Trainer refuses it too)
    time_multiple: int = 16000
    label_multiple: int = 32
    max_samples: int | None = None
    shuffle_window: int | None = None  # per-epoch batch-membership reshuffle
    log_file: str | None = None
    log_dir: str = "./saves/log"
    fedavg_weighted: bool = False   # reference uses an unweighted mean
    mesh: Any = None                # client/data/model mesh: not ported
    zero1: bool = False             # not ported
    tp: bool = False                # not ported
    # keep client datasets resident on the device across rounds and send
    # only per-round index batches. None = auto: on under ~6 GB of padded
    # [K, n_max, t_max] audio
    resident_client_data: bool | None = None
    # 1 = supervised only; < 1 (the pseudo-labeled phase) is not ported
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
    # uplink compression, secure aggregation, top-k, FedProx and FedOpt:
    # not ported
    compress_bits: int | None = None
    compress_stochastic_rounding: bool = True
    secagg_clip_norm: float | None = None
    secagg_bits: int = 20
    topk_fraction: float | None = None
    fedprox_mu: float = 0.0
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
        _check_ported(self)
        if self.dp_noise_multiplier and self.dp_clip_norm is None:
            # noise std is clip * multiplier / K: without a clip norm there
            # is no DP at all
            raise ValueError("dp_noise_multiplier > 0 requires dp_clip_norm (the noise "
                             "std is clip * multiplier / K); set --dp_clip_norm")


def _check_ported(f: FederatedConfig) -> None:
    later = {"mesh": f.mesh is not None, "zero1": f.zero1, "tp": f.tp,
             "remat": f.remat, "fedprox_mu != 0": f.fedprox_mu != 0.0,
             "server_optimizer != 'none'": f.server_optimizer != "none",
             "compress_bits": f.compress_bits is not None,
             "secagg_clip_norm": f.secagg_clip_norm is not None,
             "topk_fraction": f.topk_fraction is not None,
             "supervised_level < 1": f.supervised_level < 1.0}
    missing = [k for k, on in later.items() if on]
    if missing:
        raise NotImplementedError(
            f"federated options not ported yet: {', '.join(missing)}")


class FederatedEngine:
    """``params``: the port's DACSModel state dict (models/port.py), held as
    fp32 on ``device`` in ``global_params``."""

    def __init__(self, cfg: DACSConfig, fcfg: FederatedConfig,
                 client_examples: dict[Any, Sequence[AsrExample]],
                 public_examples: Sequence[AsrExample],
                 eval_examples: Sequence[AsrExample] | None,
                 tokenizer: CTCCharTokenizer, params: Mapping[str, torch.Tensor],
                 device: str | torch.device = "cuda"):
        if cfg.method != "dacs":
            # the reference's FL pipeline exists for the DACS model only
            raise ValueError(f"the federated engine drives the DACS method only, got "
                             f"method={cfg.method!r}")
        self.device = resolve_device(device)
        self.cfg, self.fcfg = cfg, fcfg
        self.client_ids = sorted(client_examples.keys(), key=str)
        self.client_examples = client_examples
        self.public_examples = public_examples
        self.eval_examples = eval_examples
        self.tokenizer = tokenizer
        self.global_params = {k: v.detach().to(self.device, torch.float32).clone()
                              for k, v in params.items()}
        self.logger = JsonlLogger(fcfg.log_dir, fcfg.log_file)
        self._model = None  # the one model the clients train in turn
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

    @property
    def model(self):
        """The engine's model instance (compute dtype, fp32 params)."""
        if self._model is None:
            with torch.device("meta"):
                model = get_recipe(self.cfg.method).make_model(
                    self.cfg, _DTYPES[self.fcfg.compute_dtype], torch.float32)
            self._model = model.to_empty(device=self.device)
        return self._model

    def _load_global(self):
        self.model.load_state_dict(self.global_params, strict=True)
        return self.model

    # ------------------------------------------------------------------
    # data: per-client step streams
    # ------------------------------------------------------------------

    def _client_round_batches(self, cids, round_idx: int, source: dict) -> list:
        """Staged data of one round: per client a list of DeviceBatches,
        every client padded to the round's largest step count with
        all-masked batches and every batch to the round's (T, L)."""
        f = self.fcfg
        per_client, t_max, l_max = [], 0, 0
        for cid in cids:
            batcher = LengthBucketBatcher(
                source[cid], f.batch_size, time_multiple=f.time_multiple,
                label_multiple=f.label_multiple, seed=f.seed + round_idx,
                max_samples=f.max_samples, shuffle_window=f.shuffle_window)
            batches = []
            for ep in range(f.local_ep):
                batches.extend(batcher.epoch(epoch_seed=f.seed + 1000 * round_idx + ep))
            per_client.append(batches)
            t_max = max(t_max, max(b.input_values.shape[1] for b in batches))
            l_max = max(l_max, max(b.labels.shape[1] for b in batches))
        steps = max(len(bs) for bs in per_client)
        self._last_dead_step_frac = 1.0 - sum(map(len, per_client)) / (steps * len(cids))

        def pad_to(b):
            iv = np.zeros((b.input_values.shape[0], t_max), np.float32)
            iv[:, : b.input_values.shape[1]] = b.input_values
            lab = np.full((b.labels.shape[0], l_max), -100, np.int32)
            lab[:, : b.labels.shape[1]] = b.labels
            return dataclasses.replace(b, input_values=iv, labels=lab)

        out = []
        for batches in per_client:
            dev = [DeviceBatch.from_host(pad_to(b), self.device) for b in batches]
            while len(dev) < steps:  # pad with an all-masked batch
                dummy = DeviceBatch(*(torch.zeros_like(x) for x in dataclasses.astuple(dev[0])))
                dummy.labels.fill_(-100)
                dev.append(dummy)
            out.append(dev)
        return out

    def _resident_enabled(self, source: dict) -> bool:
        f = self.fcfg
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

    def _build_round(self, stage: int, rnd: int, cids) -> tuple:
        """Host-side data build for one round: (phases, specs, dead_frac),
        one supervised phase (the unsupervised phase is not ported)."""
        phase, spec = self._resident_or_staged_phase(stage, self.client_examples, cids, rnd)
        return (phase,), (spec,), self._last_dead_step_frac

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
        return data, ("sup", len(data[0]))

    def _client_seed(self, rnd: int, ki: int, phase: int) -> int:
        """Seed of the random streams of the ``ki``-th sampled client's
        ``phase`` in round ``rnd`` (dropout, Gumbel noise)."""
        return (self.fcfg.seed + 7919 * rnd) * 1_000_003 + 97 * ki + phase

    @staticmethod
    def _phase_batches(kind: str, phase, ki: int):
        """The ``ki``-th sampled client's batches of one phase, one per step."""
        if kind == "sup":
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
        on the engine's model; returns its losses, one per step."""
        f = self.fcfg
        cfg = self.cfg.replace(stage=stage)
        model = self._load_global()
        losses = []
        for p, ((kind, steps), phase) in enumerate(zip(specs, phases)):
            tx = make_optimizer(model, stage, f.learning_rate, f.weight_decay,
                                warmup_steps=f.warmup_steps, total_steps=max(steps, 1))
            state = create_train_state(model, tx, self._client_seed(rnd, ki, p))
            step = make_hidden_train_step(cfg) if kind == "res_h" else make_train_step(cfg)
            for batch in self._phase_batches(kind, phase, ki):
                losses.append(step(state, batch)["loss"])
        return torch.stack(losses)

    def _run_round(self, stage: int, rnd: int, cids, phases, specs) -> list[float]:
        """Every sampled client in turn, FedAvg (or DP-FedAvg) of the
        stage's sub-network, graft into the global params; returns each
        client's mean step loss."""
        f = self.fcfg
        network = STAGE_NETWORK[stage]
        keys = list(select_network(self.global_params, network))
        if f.dp_clip_norm is not None:
            gen = torch.Generator(self.device).manual_seed(
                (f.seed + 7919 * rnd) * 1_000_003 + 0x5A11)
            acc = FedAvgAccumulator(keys, len(cids), global_params=self.global_params,
                                    clip_norm=f.dp_clip_norm,
                                    noise_multiplier=f.dp_noise_multiplier, generator=gen)
        else:
            weights = ([len(self.client_examples[c]) for c in cids]
                       if f.fedavg_weighted else None)
            acc = FedAvgAccumulator(keys, len(cids), weights)
        losses = []
        for ki in range(len(cids)):
            losses.append(self._local_train(stage, rnd, ki, phases, specs).mean())
            acc.add(self.model.state_dict())
        self.global_params = graft_network(self.global_params, acc.result(), network)
        return [float(x) for x in losses]

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
        if f.round_save_dir is None or rnd % max(f.round_save_every, 1):
            return
        p = save_params(Path(f.round_save_dir) / f"stage{stage}-round-{rnd}",
                        self.global_params, {"stage": stage, "round": rnd})
        if self._dp_active():
            p.with_name(p.name + "-dp.json").write_text(
                json.dumps(self._dp_accountant.state_dict()))
        ckpts = self._round_ckpts(stage)
        for _, old in ckpts[: max(0, len(ckpts) - f.round_save_limit)]:
            shutil.rmtree(old)
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
        sees the same plan."""
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
        # stages 1/2: the frozen deterministic encoder's output of every
        # utterance is computed once; the rounds train heads on it
        if stage in (1, 2) and self._resident_enabled(self.client_examples):
            self._hidden_cache_for(stage, self.client_examples)
        start_round = self._maybe_resume_rounds(stage)
        if start_round >= num_rounds:
            return self.global_params
        for rnd, cids in plan[start_round:]:
            t0 = time.perf_counter()
            phases, specs, dead_frac = self._build_round(stage, rnd, cids)
            losses = self._run_round(stage, rnd, cids, phases, specs)
            row = {"fl_round": rnd + 1, "stage": stage,
                   "clients": ",".join(str(c) for c in cids),
                   "dead_step_frac": round(dead_frac, 4),
                   **{f"client{c}_loss": loss for c, loss in zip(cids, losses)},
                   "local_steps": m * sum(s for _, s in specs), "phase": specs[0][0],
                   "round_s": time.perf_counter() - t0}
            if self._dp_active():
                self._dp_accountant.step(m / k_total, f.dp_noise_multiplier)
                row["dp_epsilon"] = round(self._dp_accountant.epsilon(), 4)
                row["dp_delta"] = f.dp_delta
            self.logger.log(row)
            if self.eval_examples is not None:
                ev = self.evaluate(stage)
                ev.update({"fl_round": rnd + 1, "stage": stage})
                self.logger.log(ev)
            self._maybe_save_round(stage, rnd + 1)
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
            self.cfg.replace(stage=stage), self.global_params, self.public_examples,
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
            tr = Trainer(self.cfg.replace(stage=stage), self.global_params, [],
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
