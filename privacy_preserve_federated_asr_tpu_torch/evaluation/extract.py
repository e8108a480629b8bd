"""Batched embedding / mask / transcript extraction (the port's
``evaluation/extract.py``; the reference's ``Extract_Emb`` / ``get_Embs`` /
``map_to_result``, centralized/eval_toggle_GS.py:68-136,
federated/src/update.py:162-212, 495-524).

One model forward per length-bucketed batch on the device under
``torch.inference_mode()``, greedy ids and the frame-majority AD vote on the
device, then per-utterance rows un-padded by frame length on the host and
stored as fp32. The row schema is the JAX package's, down to the leading
batch dimension of 1 in the pickle, so the analysis tools of either package
read the other's files.

**Gumbel noise.** The JAX extraction draws the mask noise from
``PRNGKey(seed)`` inside its jitted forward, the same key for every batch.
Here a ``torch.Generator`` on the model's device is reseeded with ``seed``
before every batch: one fixed stream per batch shape, as in JAX, but not
JAX's numbers. ``gumbel_noise`` (a function of the batch's ``[B, T, D, 2]``
mask-score shape returning the model's draws: lm and AD for the DACS model,
lm alone for single-toggle, none for FSM, whose masks are thresholds)
injects the noise instead, so that tests hand both packages the same draw.

**Row schema per method** (the JAX package's, after the reference's eval
scripts): ``dacs`` / ``toggle_more`` both masks and the AD-masked logits;
``fsm`` both threshold masks; ``single_toggle`` ``lm_mask`` only, AD logits
from the lm-masked stream; ``grl`` no masks (``Recipe.extract_streams``).

**Pickles without pandas.** The JAX package dumps rows as a pandas
DataFrame. :func:`rows_to_pickle` writes the bytes of
``DataFrame(columns)`` itself (pickle protocol 2: ``GLOBAL
pandas.core.frame DataFrame``, the pickled column dict, ``TUPLE1``,
``REDUCE``), which pandas and the JAX CLI load as the DataFrame the JAX
package writes; :func:`read_records` maps that one global to
:class:`Records`, so the port reads its pickles where pandas is not
installed. ``write_results_csv`` writes pandas' ``to_csv`` bytes with the
``csv`` module.
"""

from __future__ import annotations

import csv
import os
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ..data.collate import Batch, LengthBucketBatcher
from ..data.dataset import AsrExample
from ..data.tokenizer import CTCCharTokenizer
from ..models.backbone import feat_extract_output_lengths
from ..models.config import DACSConfig
from ..models.recipes import get_recipe
from ..ops.beam import beam_search_batch
from ..ops.decode import ad_vote, greedy_ids
from ..ops.gumbel import sample_gumbel
from ..serving.engine import resolve_device

# injected noise: the batch's mask-score shape [B, T, D, 2] -> (lm, ad) draws
NoiseFn = Callable[[tuple[int, ...]], tuple]


@dataclass
class ExtractionRow:
    """One utterance's extraction record (reference row schema:
    update.py:182-212 — path/text/dementia_labels/hidden_states/pred_str/
    dementia_mask/lm_mask/pred_AD/dementia logits). Mask fields are None for
    methods whose model doesn't produce them (eval.py/eval_finetune.py dump
    neither)."""

    path: str
    text: str | None
    dementia_labels: int
    hidden_states: np.ndarray            # [T_valid, D]
    lm_mask: np.ndarray | None           # [T_valid, D]
    dementia_mask: np.ndarray | None     # [T_valid, D]
    pred_str: str
    pred_AD: int
    dementia_logits: np.ndarray          # [T_valid, 2]


def load_model(make_model: Callable, cfg: DACSConfig,
               state_dict: Mapping[str, torch.Tensor], dtype: torch.dtype,
               device: torch.device) -> torch.nn.Module:
    """``make_model(cfg, dtype)`` on ``device`` with ``state_dict`` loaded
    (strict), in eval mode and without gradients."""
    with torch.device("meta"):
        model = make_model(cfg, dtype)
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval().requires_grad_(False)


def batch_inputs(cfg: DACSConfig, b: Batch, seed: int, generator: torch.Generator,
                 gumbel_noise: NoiseFn | None, device: torch.device, draws: int = 2):
    """A host batch's waveforms and lengths on ``device``, and its Gumbel
    noise (the model's ``draws``: lm, then AD): ``gumbel_noise(shape)`` when
    given, else ``draws`` draws from ``generator`` reseeded with ``seed``,
    the order and shapes the model's own draw takes."""
    x = torch.from_numpy(b.input_values).to(device)
    lengths = torch.from_numpy(b.input_lengths).to(device)
    shape = (x.shape[0], feat_extract_output_lengths(cfg.backbone, x.shape[1]),
             cfg.hidden_size, 2)
    if gumbel_noise is not None:
        noise = tuple(torch.as_tensor(n, device=device) for n in gumbel_noise(shape))
    else:
        generator.manual_seed(seed)
        noise = tuple(sample_gumbel(shape, generator, device) for _ in range(draws))
    return x, lengths, noise


def _host(t: torch.Tensor | None) -> np.ndarray | None:
    return None if t is None else t.float().cpu().numpy()


def extract_embeddings(
    cfg: DACSConfig,
    state_dict: Mapping[str, torch.Tensor],
    examples: Sequence[AsrExample],
    tokenizer: CTCCharTokenizer,
    batch_size: int = 16,
    time_multiple: int = 16000,
    seed: int = 0,
    compute_dtype: str = "float32",
    beam_size: int = 0,
    lm_fn=None,
    lm_alpha: float = 0.3,
    lm_beta: float = 0.0,
    mesh=None,
    device: str | torch.device = "cuda",
    gumbel_noise: NoiseFn | None = None,
) -> list[ExtractionRow]:
    """Rows of every example, in the batcher's order (epoch seed 0).

    ``state_dict`` holds the weights of the method's model. ``compute_dtype``
    "float32" (the reference's extraction precision, the default),
    "bfloat16" (the serving precision) or "int8" (bf16 with W8A8 Dense
    matmuls, ops/quant.py); rows are fp32 in every case.
    ``beam_size > 0`` decodes ``pred_str`` with CTC prefix beam search on the
    host over the forward's fp32 log-posteriors (ops/beam.py; optional
    shallow LM fusion ``lm_fn``) instead of the reference's greedy argmax.
    ``mesh`` data parallelism is not ported yet and raises. Runs on ``device`` (``cuda`` unless the caller asks for the
    CPU)."""
    if mesh is not None:
        raise NotImplementedError("data-parallel extraction (mesh) is not ported yet")
    device = resolve_device(device)
    cfg, dtype = cfg.resolve_compute(compute_dtype)
    recipe = get_recipe(cfg.method)
    model = load_model(recipe.make_model, cfg, state_dict, dtype, device)
    generator = torch.Generator(device)
    batcher = LengthBucketBatcher(examples, batch_size, time_multiple=time_multiple)
    by_path = {e.path: e for e in examples}
    rows: list[ExtractionRow] = []
    for b in batcher.epoch(epoch_seed=0):
        with torch.inference_mode():
            x, lengths, noise = batch_inputs(cfg, b, seed, generator, gumbel_noise, device,
                                             model.gumbel_draws)
            out = model(x, lengths, gumbel_noise=noise)
            ctc_logits, ad_logits, lm_mask, ad_mask = recipe.extract_streams(out, cfg)
            pred = greedy_ids(ctc_logits, out.frame_mask, cfg.backbone.pad_token_id)
            ad_pred = ad_vote(ad_logits, out.frame_mask)
            h, dlog, lm, ad = map(_host, (out.hidden_states, ad_logits, lm_mask, ad_mask))
            pred, ad_pred, flen = (t.cpu().numpy() for t in (pred, ad_pred,
                                                             out.frame_lengths))
            if beam_size > 0:
                lp = torch.log_softmax(ctc_logits.float(), dim=-1).cpu().numpy()
        n_real = len(b.paths)
        if beam_size > 0:
            beams = beam_search_batch(
                lp[:n_real], flen[:n_real], beam_size=beam_size,
                blank_id=cfg.backbone.pad_token_id, lm_fn=lm_fn,
                lm_alpha=lm_alpha, lm_beta=lm_beta)
            texts = [tokenizer.decode(bm[0].ids, group_tokens=False) for bm in beams]
        else:
            texts = [tokenizer.decode(pred[i]) for i in range(n_real)]
        for i, path in enumerate(b.paths):
            n = int(flen[i])
            ex = by_path[path]
            rows.append(ExtractionRow(
                path=path,
                text=ex.text,
                dementia_labels=ex.dementia_label,
                hidden_states=h[i, :n],
                lm_mask=None if lm is None else lm[i, :n],
                dementia_mask=None if ad is None else ad[i, :n],
                pred_str=texts[i],
                pred_AD=int(ad_pred[i]),
                dementia_logits=dlog[i, :n],
            ))
    return rows


def write_results_csv(rows: list[ExtractionRow], save_path: str) -> None:
    """ASR output CSV with GroundTruth/PredStr columns (reference
    ``WriteResult``, centralized/utils.py:113-116): the bytes pandas'
    ``DataFrame.to_csv`` writes, index column included."""
    Path(save_path).mkdir(parents=True, exist_ok=True)
    with open(f"{save_path}/Result.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator=os.linesep)
        w.writerow(["", "GroundTruth", "PredStr"])
        for i, r in enumerate(rows):
            w.writerow([i, "" if r.text is None else r.text, r.pred_str])
    print(f"Writing results to {save_path}")


def _row_dict(r: ExtractionRow) -> dict:
    d = {
        "path": r.path,
        "text": r.text,
        "dementia_labels": r.dementia_labels,
        # reference stores [1, T, D] (batch dim kept) — keep that shape
        "hidden_states": r.hidden_states[None],
        "pred_str": r.pred_str,
        "pred_AD": r.pred_AD,
        "dementia_logits": r.dementia_logits[None],
    }
    # mask columns only where the method produces them
    if r.lm_mask is not None:
        d["lm_mask"] = r.lm_mask[None]
    if r.dementia_mask is not None:
        d["dementia_mask"] = r.dementia_mask[None]
    return d


def rows_to_pickle(rows: list[ExtractionRow], path: str) -> None:
    """Dump rows as the pickle of a pandas DataFrame with the reference's
    column names, written without pandas (module docstring)."""
    dicts = [_row_dict(r) for r in rows]
    columns = {k: [d[k] for d in dicts] for k in (dicts[0] if dicts else ())}
    body = pickle.dumps(columns, protocol=2)  # PROTO 2 ... STOP
    data = (body[:2] + pickle.GLOBAL + b"pandas.core.frame\nDataFrame\n" + body[2:-1]
            + pickle.TUPLE1 + pickle.REDUCE + pickle.STOP)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


class Records:
    """An extraction pickle read back without pandas: the DataFrame's
    columns, and its rows as ``DataFrame.to_dict("records")`` gives them."""

    def __init__(self, columns: Mapping[str, Sequence]):
        self.columns = dict(columns)

    def to_dict(self, orient: str = "records") -> list[dict]:
        if orient != "records":
            raise ValueError(f"Records.to_dict supports orient='records' only, got {orient!r}")
        return [dict(zip(self.columns, vals)) for vals in zip(*self.columns.values())]


class _WrittenByPandas(Exception):
    pass


class _RecordsUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) == ("pandas.core.frame", "DataFrame"):
            return Records
        if module.split(".")[0] == "pandas":  # pandas' own DataFrame state
            raise _WrittenByPandas(f"{module}.{name}")
        return super().find_class(module, name)


def read_records(path: str) -> list[dict]:
    """The rows of an extraction pickle as dicts. A pickle that
    :func:`rows_to_pickle` wrote needs neither pandas nor the JAX package;
    one that pandas itself wrote (the JAX package's ``rows_to_pickle``)
    needs pandas."""
    with open(path, "rb") as f:
        try:
            return _RecordsUnpickler(f).load().to_dict("records")
        except _WrittenByPandas as e:
            pandas_global = str(e)
    try:
        import pandas as pd
    except ImportError:
        raise ImportError(f"{path} was written by pandas itself (it holds "
                          f"{pandas_global}); reading it needs pandas, which is not "
                          f"installed") from None
    return pd.read_pickle(path).to_dict("records")
