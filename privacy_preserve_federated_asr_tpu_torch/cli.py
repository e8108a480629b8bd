"""Command-line interface of the port: ``train``, ``federated``, ``serve``,
``extract``, ``svm``, ``detail-wer``, ``feat-scoring``, ``pkl2csv``,
``dp-budget``, ``transcribe``, ``teacher``, ``export-hf``, ``text`` and
``sweep`` (the JAX package's subcommands of those names, same flags, plus
``--device``; only ``--no_fast_rng``, a switch of the TPU's RNG, is absent).

    python -m privacy_preserve_federated_asr_tpu_torch.cli train \
        --model_type data2vec -st 0 --epochs 30 --audio_dir ... \
        --train_csv ... --test_csv ... --spk2label ... -model_out ./saves/model
    python -m privacy_preserve_federated_asr_tpu_torch.cli federated \
        --model_type data2vec -fl_st 0 --num_users 2 --epochs 10 --local_ep 5 \
        --global_ep 30 --audio_dir ... --train_csv ... --test_csv ... \
        --spk2label ... -model_out ./saves/model
    python -m privacy_preserve_federated_asr_tpu_torch.cli serve \
        --model_type data2vec --STAGE 2 --port 8008 [--model_in ckpt.bin] \
        [--compute_dtype int8] [--transport int16] [--no_hub]
    python -m privacy_preserve_federated_asr_tpu_torch.cli stream-client \
        --port 8008 --audio clip.wav --chunk_seconds 0.5
    python -m privacy_preserve_federated_asr_tpu_torch.cli stream-report \
        --model_type data2vec -st 2 -model_in ... --audio_dir ... --test_csv ... \
        --right_context_grid 0.25 0.5 1.0
    python -m privacy_preserve_federated_asr_tpu_torch.cli extract \
        --model_type data2vec -st 2 -model_in ./saves/model_final_global/final \
        --audio_dir ... --train_csv ... --test_csv ... --spk2label ... \
        -csv extract --csv_out_dir ./saves/results
    python -m privacy_preserve_federated_asr_tpu_torch.cli svm \
        --train_pkl ./saves/results/extract_train.pkl \
        --test_pkl ./saves/results/extract.pkl --spk2label ... -sq mean
    python -m privacy_preserve_federated_asr_tpu_torch.cli detail-wer \
        --pkl ./saves/results/extract.pkl -t 2
    python -m privacy_preserve_federated_asr_tpu_torch.cli feat-scoring \
        --pkl ./saves/results/extract.pkl
    python -m privacy_preserve_federated_asr_tpu_torch.cli transcribe \
        --model_type data2vec -st 2 -model_in ... --audio clips/ --out t.csv \
        [--beam_size 8 --lm_train_csv train.csv]
    python -m privacy_preserve_federated_asr_tpu_torch.cli export-hf \
        --model_type data2vec -st 2 -model_in ... --out export/pytorch_model.bin
    python -m privacy_preserve_federated_asr_tpu_torch.cli sweep asr \
        --model_type data2vec -st 0 --grid learning_rate=1e-5,1e-4 ...
    python -m privacy_preserve_federated_asr_tpu_torch.cli sweep svm \
        --train_pkl ... --test_pkl ... --spk2label ... --preset dementia-svm

    python -m privacy_preserve_federated_asr_tpu_torch.cli teacher \
        --model_type data2vec -st 0 -model_in ... --audio_dir ... \
        --train_csv unlabeled.csv --out saves/teacher/unsup.csv \
        [--whisper_hf whisper-large-v2/ [--no-timestamps]]
    python -m privacy_preserve_federated_asr_tpu_torch.cli text \
        --train_pkl extract_train.pkl --test_pkl extract.pkl \
        [--bert_checkpoint bert/pytorch_model.bin --vocab bert/vocab.txt] \
        [--finetune --max_length 128] [--experiment sentence_1input]

``--method`` is any of the five method families (``dacs``, ``toggle_more``,
``grl``, ``single_toggle``, ``fsm``; ``federated`` takes ``dacs`` only) and
``--model_type sewd`` selects the SEW-D backbone (``export-hf`` has no ForCTC
layout for it and raises); ``--model_type xlsr-2b`` selects XLS-R 2B
(``facebook/wav2vec2-xls-r-2b``: 48 pre-LN blocks at 1920, 16 heads of
120, the attention kernels' second head dim). ``--model_in`` takes a port checkpoint (a
``final/`` export or a ``checkpoint-<step>/`` directory of ``train``), or a
ForCTC torch state dict as the JAX package's and the port's ``cli
export-hf`` write it (or an HF encoder/ForCTC ``pytorch_model.bin`` or
``model.safetensors``, SEW-D's ``sew_d.`` prefix included). Of the file's
heads, those the method's model has at the same shape are carried over; a
head at another shape is skipped with a warning (a DACS checkpoint's D->4D
arbitrator under ``--method single_toggle``), and every head not carried
keeps its random init. Without it the weights are a random init from
``--seed``. Every command that runs a
model or the SVM runs on ``--device`` (default ``cuda``; with no GPU it
exits with an error rather than run on the CPU). ``federated`` writes
``<model_out>_FLASR_global/final``, ``<model_out>_FLAD_global/final`` and
``<model_out>_final_global/final`` (per ``-fl_st``), each loadable with
``--model_in``. ``extract`` writes ``<csv_name>.pkl`` (test CSV),
``<csv_name>_train.pkl`` and the test set's ``Result.csv``; the analysis
commands read those pickles without pandas (``evaluation/extract.py``).
``serve``, ``extract`` and ``transcribe`` decode greedily unless
``--beam_size > 0`` (CTC prefix beam search on the host, ``ops/beam.py``,
with a character-bigram LM fitted on ``--lm_train_csv`` for shallow fusion).
``--compute_dtype int8`` (``serve``, ``extract``, ``transcribe``,
``stream-report``) runs bf16 with W8A8 Dense matmuls and ``--int8``
(``train``, ``federated``) trains with them (``ops/quant.py``). ``serve``
also answers the streaming routes ``/stream/*`` (``--no_hub``: standalone
sessions only; ``--transport int16``: int16 uploads); ``stream-client``
streams a WAV to it and ``stream-report`` measures the finalization flip
rate per right context. ``teacher`` labels an unlabeled CSV with the
model's greedy transcripts (the self-training teacher) and writes the CSV
``federated --unsup_train_csv`` takes, with a transcript JSON beside it;
``teacher --whisper_hf <dir>`` makes an HF Whisper checkpoint the teacher
(long-form windows, the temperature fallback, timestamps unless
``--no-timestamps``; the directory's ``vocab.json`` and added tokens
detokenize, ``data/whisper_tokens.py``). ``text`` trains the text-branch AD
classifier on session documents of extraction pickles (hashed bag of words,
or a BERT checkpoint frozen or with ``--finetune``, or a registry
``--experiment``); ``svm --mode text|fusion`` reads session text embeddings
from ``--text_train_pkl/--text_test_pkl`` and ``sweep text`` replays the
BERT grids.

The parallel options (``train``/``sweep asr`` ``--dp``/``--tp``/``--pp``/
``--sp``/``--zero1``, ``federated`` ``--client_mesh``/``--data_mesh``/
``--model_mesh``/``--num_slices``/``--fl_zero1``, ``extract --dp``, ``text
--finetune --dp``) run one rank per device (``parallel/``): the command
starts its own ranks (``python -m <package>.cli <the same arguments>``, one
process each) and waits for them, or, inside a process group a launcher
such as ``torchrun`` started, runs as one of them. More ranks than devices
are refused with JAX's message; ``DACS_RANKS_PER_DEVICE=n`` places n ranks
on each device (the CPU counts as one). Rank 0 prints and writes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

BACKBONES = {
    "data2vec": "data2vec_audio_large",
    "data2vec-base": "data2vec_audio_base",
    "wav2vec2": "wav2vec2_large_960h_lv60",
    "wav2vec2-base": "wav2vec2_base_960h",
    "xlsr-2b": "wav2vec2_xls_r_2b",
    "hubert": "hubert_large_ls960",
    "sewd": "sew_d_mid",
    "unispeech": "unispeech_sat_large",
    "tiny": "tiny_for_tests",  # smoke tests
}
METHODS = ["dacs", "toggle_more", "grl", "single_toggle", "fsm"]


def _run_here(args, world: int, check=None) -> bool:
    """Whether this process runs the command: on one rank, or as a rank of
    a process group. Otherwise ``check(devices)`` refuses a layout that
    needs more devices than there are, the command's ``world`` ranks are
    started here and waited for, and the answer is False."""
    from .parallel import dist as pdist

    if world <= 1 or pdist.is_parallel() or pdist.in_launched_rank():
        return True
    if check is not None:
        check(pdist.device_count(args.device))
    rc = pdist.launch_cli(args.argv, world)
    if rc:
        raise SystemExit(f"[{args.cmd}] {world} ranks: a rank exited with code {rc}")
    return False


def _lead() -> bool:
    """Whether this rank prints and writes (rank 0, or the only one)."""
    from .parallel import dist as pdist

    return pdist.rank() == 0


def _dacs_cfg(args):
    from .models import BackboneConfig, DACSConfig

    backbone = getattr(BackboneConfig, BACKBONES[args.model_type])()
    if getattr(args, "int8", False):
        backbone = backbone.replace(dense_impl="int8_train")
    train = dict(lambda_grl=args.LAMBDA, ad_loss=args.AD_loss,
                 w_loss=tuple(args.W_LOSS) if args.W_LOSS else (0.1, 0.9),
                 grl_reverse=args.GRL) if args.cmd in ("train", "federated", "sweep") else {}
    return DACSConfig(
        backbone=backbone,
        method=args.method,
        stage=args.STAGE,
        gs_tau=args.GS_TAU,
        toggle_ratio=args.TOGGLE_RATIO,
        num_lms=getattr(args, "num_lms", 1),
        **train,
    )


def load_weights(cfg, model_in: str | None, seed: int = 0,
                 device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Weights of the method's model: a seeded random init (generator on
    ``device``), with a port checkpoint or a torch checkpoint's encoder and
    heads carried over it when ``model_in`` is given. A torch checkpoint is
    a file (``.bin`` or ``.safetensors``) or an HF directory holding
    ``pytorch_model.bin`` or, failing that, ``model.safetensors``. Its
    encoder must match the model's shapes (else ``ValueError``); its heads
    are grafted by :func:`_graft_matching_heads`."""
    from .models import init_dacs_state_dict, state_dict_from_hf
    from .models.port import read_safetensors
    from .train.checkpoint import load_state_dict

    gen = torch.Generator(device).manual_seed(seed)
    sd = init_dacs_state_dict(cfg, gen)
    if not model_in:
        print("[init] random init (no --model_in given)")
        return sd
    own = load_state_dict(model_in)
    if own is not None:
        print(f"[init] port checkpoint {model_in}")
        if set(own) != set(sd):
            raise KeyError(f"checkpoint {model_in} does not match the model: "
                           f"missing {sorted(set(sd) - set(own))[:5]}, unexpected "
                           f"{sorted(set(own) - set(sd))[:5]}")
        return {k: v.float() for k, v in own.items()}
    path = Path(model_in)
    if path.is_dir():  # an HF directory: the JAX package's two candidates
        path = next((path / c for c in ("pytorch_model.bin", "model.safetensors")
                     if (path / c).exists()), path / "pytorch_model.bin")
    print(f"[init] torch checkpoint {path}")
    raw = (read_safetensors(str(path)) if path.suffix == ".safetensors"
           else torch.load(str(path), map_location="cpu", weights_only=True))
    ported = state_dict_from_hf(raw, cfg)
    heads = {}
    for k, v in ported.items():
        if not k.startswith("backbone."):
            heads[k] = v
        elif v.shape != sd[k].shape:
            raise ValueError(f"checkpoint {k} has shape {tuple(v.shape)}, the "
                             f"model {tuple(sd[k].shape)} (wrong --model_type?)")
        else:
            sd[k] = v
    return _graft_matching_heads(sd, heads)


def _graft_matching_heads(sd: dict[str, torch.Tensor],
                          heads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Carry each checkpoint head (``lm_head``, ``arbitrator``,
    ``lm_heads.0``, ...) into ``sd`` in place, only where the method's model
    has it and only at the same keys and shapes (the JAX CLI's
    ``_graft_matching_heads``): the variants share the backbone but not the
    heads, e.g. single-toggle's arbitrator is D->2D where DACS's is D->4D.
    A head at another shape is skipped loudly and keeps its random init."""
    def shapes(d, head):
        return {k: tuple(v.shape) for k, v in d.items() if k.rsplit(".", 1)[0] == head}

    for head in sorted({k.rsplit(".", 1)[0] for k in heads}):
        have = shapes(sd, head)
        if not have:  # the method's model has no such head
            continue
        got = shapes(heads, head)
        if got == have:
            sd.update({k: heads[k] for k in got})
        else:
            print(f"[load] WARNING: checkpoint head '{head}' shape {got} != model's "
                  f"{have} — skipped (wrong --method or vocab for this checkpoint?)")
    return sd


def _fit_shallow_fusion_lm(args, tok, cfg):
    """Char-bigram LM for beam-search shallow fusion, fitted on the
    transcripts CSV — shared by extract, serve and transcribe. None when
    beam decoding or the LM CSV is not requested."""
    if not (getattr(args, "beam_size", 0) > 0 and args.lm_train_csv):
        return None
    import csv

    from .ops.beam import CharBigramLM

    with open(args.lm_train_csv, newline="") as f:
        seqs = [tok.encode(row["sentence"].upper())
                for row in csv.DictReader(f) if row.get("sentence")]
    return CharBigramLM(cfg.backbone.vocab_size).fit(seqs)


def _engine(args, device):
    """The InferenceEngine of ``serve`` and ``transcribe``."""
    from .data.tokenizer import CTCCharTokenizer
    from .serving import InferenceEngine, ServingConfig

    cfg = _dacs_cfg(args)
    tok = CTCCharTokenizer()
    return InferenceEngine(
        cfg, load_weights(cfg, args.model_in_path, args.seed, device), tok,
        ServingConfig(batch_size=args.eval_batch_size,
                      max_seconds=args.max_seconds,
                      batch_window_ms=getattr(args, "batch_window_ms", 10.0),
                      compute_dtype=args.compute_dtype,
                      beam_size=getattr(args, "beam_size", 0),
                      lm_alpha=getattr(args, "lm_alpha", 0.3),
                      lm_beta=getattr(args, "lm_beta", 0.0),
                      transport=getattr(args, "transport", "float32")),
        lm_fn=_fit_shallow_fusion_lm(args, tok, cfg), device=device)


def cmd_serve(args):
    from .serving import serve_forever
    from .serving.engine import resolve_device

    engine = _engine(args, resolve_device(args.device))
    serve_forever(engine, host=args.host, port=args.port,
                  warmup=not args.no_warmup, use_hub=not args.no_hub)


def cmd_stream_client(args):
    """Streaming client of ``serve``: chunk a WAV (or synthetic noise) and
    feed it to ``/stream/*`` as binary float32 PCM (``--json_transport``:
    JSON float lists), printing each partial and the final result as JSON
    lines; returns the final result."""
    import urllib.request

    import numpy as np

    from .data.audio import load_audio

    if args.audio:
        wave = load_audio(args.audio, target_sr=16000, normalize=False).astype(np.float32)
    else:  # synthetic smoke input
        wave = np.random.default_rng(args.seed).normal(
            0, 0.3, size=int(args.synthetic_seconds * 16000)).astype(np.float32)
    chunk = max(int(args.chunk_seconds * 16000), 1)
    base = f"http://{args.host}:{args.port}"

    def post(path, body=b"{}", binary=False):
        req = urllib.request.Request(
            base + path, data=body, method="POST",
            headers={"Content-Type": "application/octet-stream" if binary
                     else "application/json"})
        with urllib.request.urlopen(req, timeout=args.timeout) as r:
            return json.loads(r.read())

    sid = post("/stream/start")["session"]
    for i in range(0, len(wave), chunk):
        piece = wave[i : i + chunk]
        if args.json_transport:
            body, binary = json.dumps({"audio": piece.tolist()}).encode(), False
        else:
            body, binary = piece.astype("<f4").tobytes(), True
        r = post(f"/stream/{sid}", body, binary=binary)
        print(json.dumps({"partial": r["transcript"], "final_frames": r["final_frames"],
                          "total_frames": r["total_frames"]}), flush=True)
    final = post(f"/stream/{sid}/finish")
    print(json.dumps(final), flush=True)
    return final


def cmd_stream_report(args):
    """Streaming finalization stability on the test CSV's audio, so the
    deployment can choose ``right_context_seconds`` from data: one JSON row
    per right context (the flip rate of early-finalized frames against the
    full-context decode); returns the rows."""
    from .serving import measure_finalization_flips
    from .serving.engine import resolve_device

    device = resolve_device(args.device)
    exs, _ = _load_examples(args, args.test_csv)
    if args.max_utts:
        exs = exs[: args.max_utts]
    rows = measure_finalization_flips(
        _engine(args, device), [e.array for e in exs],
        right_context_grid=tuple(args.right_context_grid), hop_seconds=args.hop_seconds)
    for r in rows:
        print(json.dumps(r))
    return rows


def _load_examples(args, csv_path, with_transcript=True):
    """The CSV's examples; among ranks, rank 0 writes the dataset cache
    before the others read it."""
    from .data.dataset import csv_to_examples, load_spk2label, prepare_examples
    from .data.tokenizer import CTCCharTokenizer
    from .parallel import dist as pdist

    tok = CTCCharTokenizer()
    spk2label = load_spk2label(args.spk2label) if args.spk2label else {}

    def load():
        return csv_to_examples(args.audio_dir, csv_path, spk2label,
                               with_transcript=with_transcript, cache_dir=args.dataset_cache)

    if pdist.is_parallel() and args.dataset_cache:
        import torch.distributed as dist

        exs = load() if pdist.rank() == 0 else None
        dist.barrier()
        exs = load() if exs is None else exs
    else:
        exs = load()
    return prepare_examples(exs, tok), tok


def cmd_train(args):
    """Train, then print the final evaluation; returns the Trainer."""
    from .parallel import dist as pdist
    from .serving.engine import resolve_device
    from .train.trainer import Trainer, TrainerConfig, check_devices, validate_layout

    cfg = _dacs_cfg(args)
    tcfg = TrainerConfig(
        num_epochs=args.epochs, batch_size=args.train_batch_size,
        eval_batch_size=args.eval_batch_size, learning_rate=args.learning_rate,
        eval_steps=args.eval_steps, seed=args.seed,
        compute_dtype=args.compute_dtype, remat=args.remat,
        scan_layers=args.scan_layers, dp=args.dp, tp=args.tp, pp=args.pp,
        pp_microbatches=args.pp_microbatches, sp=args.sp, zero1=args.zero1,
        grad_accum=args.grad_accum,
        cache_encoder=False if args.no_cache_encoder else None,
        cache_frontend=False if args.no_cache_frontend else None,
        log_file=args.log_path, save_dir=args.model_out_path,
        resume_from=args.checkpoint)
    if not _run_here(args, validate_layout(cfg, tcfg), lambda have: check_devices(tcfg, have)):
        return None
    device = pdist.init_distributed(resolve_device(args.device))
    train_exs, tok = _load_examples(args, args.train_csv)
    test_exs, _ = _load_examples(args, args.test_csv)
    sd = load_weights(cfg, args.model_in_path, args.seed, device)
    tr = Trainer(cfg, sd, train_exs, test_exs, tok, tcfg, device=device)
    tr.train()
    ev = tr.evaluate()
    if _lead():
        print(json.dumps(ev))
    return tr


def cmd_federated(args):
    """The 3-stage FedAvg pipeline, then print the final evaluation; returns
    the FederatedEngine."""
    from .data.splits import CLIENT_SPLITS_ADRESS, filter_by_speakers
    from .federated import FederatedConfig, FederatedEngine
    from .parallel import dist as pdist
    from .serving.engine import resolve_device
    from .train.checkpoint import save_params

    device = pdist.init_distributed(resolve_device(args.device))
    if args.scan_layers or args.dp > 1 or args.tp > 1:
        print("[federated] note: --scan_layers/--dp/--tp apply to `train` only; FL "
              "parallelism is the engine's (client, data) mesh (FederatedConfig.mesh)")
    mesh = None
    if args.client_mesh > 1 or args.data_mesh > 1 or args.model_mesh > 1:
        from .parallel import make_mesh, make_multislice_mesh

        if args.num_slices:
            if args.model_mesh > 1:
                raise ValueError("--model_mesh is not supported with --num_slices "
                                 "(the multislice layout has no model axis)")
            mesh = make_multislice_mesh(client=args.client_mesh, data=args.data_mesh,
                                        num_slices=args.num_slices)
        else:
            mesh = make_mesh(client=args.client_mesh, data=args.data_mesh,
                             model=args.model_mesh)
        if not _run_here(args, mesh.size):
            return None
        if _lead():
            print(f"[federated] device mesh: client={args.client_mesh} x "
                  f"data={args.data_mesh}"
                  + (f" x model={args.model_mesh}" if args.model_mesh > 1 else "")
                  + (f" over {args.num_slices} slices" if args.num_slices else ""))
    fcfg = FederatedConfig(
        num_rounds=args.epochs, num_clients=args.num_users, frac=args.frac,
        local_ep=args.local_ep, global_ep=args.global_ep,
        batch_size=args.train_batch_size, eval_batch_size=args.eval_batch_size,
        seed=args.seed, learning_rate=args.learning_rate,
        compute_dtype=args.compute_dtype, remat=args.remat,
        log_file=args.log_path, supervised_level=args.supervised_level,
        cache_encoder=False if args.no_cache_encoder else None,
        dp_clip_norm=args.dp_clip_norm, dp_noise_multiplier=args.dp_noise_multiplier,
        dp_delta=args.dp_delta, compress_bits=args.compress_bits,
        secagg_clip_norm=args.secagg_clip_norm, secagg_bits=args.secagg_bits,
        topk_fraction=args.topk_fraction, fedprox_mu=args.fedprox_mu,
        server_optimizer=args.server_optimizer, server_lr=args.server_lr,
        server_momentum=args.server_momentum, round_save_dir=args.round_save_dir,
        mesh=mesh, zero1=args.fl_zero1, tp=args.model_mesh > 1)

    cfg = _dacs_cfg(args)
    train_exs, tok = _load_examples(args, args.train_csv)
    test_exs, _ = _load_examples(args, args.test_csv)
    # the global params are single-head; the N-best heads (num_lms > 1) are
    # per-client scratch inside a round
    sd = load_weights(cfg.replace(num_lms=1), args.model_in_path, args.seed, device)
    clients = {cid: filter_by_speakers(train_exs, CLIENT_SPLITS_ADRESS.get(cid, ()))
               for cid in range(args.num_users)}
    # unlabeled (teacher-transcribed) per-client data for supervised_level
    # < 1 (reference: ADReSSo, federated_main.py:279-296)
    unsup_clients = None
    if args.supervised_level < 1.0:
        assert args.unsup_train_csv, "--supervised_level < 1 needs --unsup_train_csv"
        from .data.splits import CLIENT_SPLITS_ADRESSO

        unsup_exs, _ = _load_examples(args, args.unsup_train_csv)
        unsup_clients = {
            cid: filter_by_speakers(unsup_exs, CLIENT_SPLITS_ADRESSO.get(cid, ()))
            for cid in range(args.num_users)}
        if any(len(v) == 0 for v in unsup_clients.values()):
            speakers = sorted({e.path.split("_")[0] for e in unsup_exs})
            unsup_clients = {
                cid: filter_by_speakers(unsup_exs, speakers[cid::args.num_users])
                for cid in range(args.num_users)}
    public = filter_by_speakers(train_exs, CLIENT_SPLITS_ADRESS["public"])
    if any(len(v) == 0 for v in clients.values()) or len(public) == 0:
        # the dataset does not use the ADReSS speaker ids: partition the
        # speakers round-robin instead (public = all)
        print("[federated] ADReSS speaker splits empty for this dataset; "
              "partitioning speakers round-robin across clients")
        speakers = sorted({e.path.split("_")[0] for e in train_exs})
        clients = {cid: filter_by_speakers(train_exs, speakers[cid::args.num_users])
                   for cid in range(args.num_users)}
        public = train_exs
    eng = FederatedEngine(cfg, fcfg, clients, public, test_exs, tok, sd, device=device,
                          client_unsup_examples=unsup_clients)
    del sd
    out = str(Path(args.model_out_path))
    for fl_stage, run, name in ((1, eng.run_stage1, "FLASR"), (2, eng.run_stage2, "FLAD"),
                                (3, eng.run_stage3, "final")):
        if args.FL_STAGE in (fl_stage, 0):
            run()
            if _lead():
                save_params(f"{out}_{name}_global/final", eng.global_params,
                            {"fl_stage": fl_stage})
    ev = eng.evaluate(stage=min(max(args.FL_STAGE - 1, 0), 2))
    if _lead():
        print(json.dumps(ev))
    return eng


def cmd_extract(args):
    """Extraction rows of the test and train CSVs: ``<csv_name>.pkl``,
    ``<csv_name>_train.pkl`` and the test set's ``Result.csv``."""
    from .evaluation import extract_embeddings, rows_to_pickle, write_results_csv
    from .parallel import dist as pdist
    from .serving.engine import resolve_device

    device = pdist.init_distributed(resolve_device(args.device))
    mesh = None
    if args.dp > 1:  # reference: torch DataParallel eval (--GPU_batchsize)
        from .parallel import make_mesh

        mesh = make_mesh(client=1, data=args.dp)
        if not _run_here(args, mesh.size):
            return None
    cfg = _dacs_cfg(args)
    sd = load_weights(cfg, args.model_in_path, args.seed, device)
    out_dir = Path(args.csv_out_dir)
    lm_fn = None
    for split, csv_path in (("", args.test_csv), ("_train", args.train_csv)):
        exs, tok = _load_examples(args, csv_path)
        if lm_fn is None:
            lm_fn = _fit_shallow_fusion_lm(args, tok, cfg)
        rows = extract_embeddings(cfg, sd, exs, tok, batch_size=args.eval_batch_size,
                                  compute_dtype=args.compute_dtype, beam_size=args.beam_size,
                                  lm_fn=lm_fn, lm_alpha=args.lm_alpha,
                                  lm_beta=args.lm_beta, mesh=mesh, device=device)
        if not _lead():
            continue
        rows_to_pickle(rows, str(out_dir / f"{args.csv_name}{split}.pkl"))
        if split == "":  # the reference writes Result.csv for the test set
            write_results_csv(rows, str(out_dir))
        print(f"[extract] wrote {len(rows)} rows -> {out_dir}/{args.csv_name}{split}.pkl")


def cmd_svm(args):
    from .data.dataset import load_spk2label
    from .evaluation import predict_ad_svm, read_records
    from .serving.engine import resolve_device

    device = resolve_device(args.device)
    text_train = text_test = None
    if args.text_train_pkl:   # session -> text embedding tables
        t1, t2 = read_records(args.text_train_pkl), read_records(args.text_test_pkl)
        text_train = {r["session"]: r["Embedding"] for r in t1}
        text_test = {r["session"]: r["Embedding"] for r in t2}
    m = predict_ad_svm(
        read_records(args.train_pkl), read_records(args.test_pkl),
        load_spk2label(args.spk2label), pooling=args.squeeze, masked=args.masked,
        mode=args.mode, text_embeddings_train=text_train, text_embeddings_test=text_test,
        par_only=not args.INV, results_csv=args.results_csv, title=args.title, device=device)
    print(json.dumps(m))


def cmd_detail_wer(args):
    import numpy as np

    from .evaluation import detailed_wer_report, read_records

    id2mmse = None
    if args.id2mmse:
        id2mmse = np.load(args.id2mmse, allow_pickle=True).tolist()
    rep = detailed_wer_report(read_records(args.pkl), level=args.type, id2mmse=id2mmse,
                              out_dir=args.out_dir)
    print(json.dumps(rep, indent=2))


def cmd_feat_scoring(args):
    import numpy as np

    from .evaluation import mask_node_statistics, per_utt_on_rates, read_records

    rows = read_records(args.pkl)
    stats = mask_node_statistics(rows)
    rates = per_utt_on_rates(rows)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "node_stats.npz", **stats)
    np.savez(out / "utt_on_rates.npz", **rates)
    print(json.dumps({k: float(np.mean(v)) for k, v in {**stats, **rates}.items()}))


def cmd_pkl2csv(args):
    """Extraction pkl -> CSV with the text columns (reference:
    centralized/utils/PKL2csv.py — path/text/dementia_labels/pred_str
    [+Summary] kept, arrays dropped), the bytes of pandas' ``to_csv``."""
    import csv

    from .evaluation import read_records

    rows = read_records(args.pkl)
    cols = [c for c in ("path", "text", "dementia_labels", "pred_str", "Summary")
            if rows and c in rows[0]]
    out = args.out or str(Path(args.pkl).with_suffix(".csv"))
    with open(out, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator=os.linesep)
        w.writerow(cols)
        for r in rows:
            w.writerow(["" if r[c] is None else r[c] for c in cols])
    print(json.dumps({"rows": len(rows), "columns": cols, "csv": out}))


def cmd_dp_budget(args):
    """Plan a DP-FedAvg run's privacy budget before spending any compute:
    epsilon after each stage's rounds for the given sampling fraction and
    noise multiplier (the RDP accountant ``federated/privacy.py`` that the
    engine logs as dp_epsilon during a run)."""
    from .federated.privacy import DpAccountant, noise_for_epsilon

    if (args.noise_multiplier is None) == (args.target_epsilon is None):
        raise SystemExit("dp-budget: give exactly one of --noise_multiplier "
                         "(forward) or --target_epsilon (inverse)")
    k = args.num_users
    q = max(int(args.frac * k), 1) / k
    if args.target_epsilon is not None:
        z = noise_for_epsilon(args.rounds, q, args.target_epsilon, args.delta)
        print(json.dumps({
            "num_users": k, "frac": args.frac, "q": round(q, 6),
            "rounds": args.rounds, "delta": args.delta,
            "target_epsilon": args.target_epsilon,
            "noise_multiplier": round(z, 4),
        }))
        return
    acc = DpAccountant(delta=args.delta)
    trace = []
    for rnd in range(1, args.rounds + 1):
        acc.step(q, args.noise_multiplier)
        if rnd % max(args.report_every, 1) == 0 or rnd == args.rounds:
            trace.append({"round": rnd, "epsilon": round(acc.epsilon(), 4)})
    print(json.dumps({
        "num_users": k, "frac": args.frac, "q": round(q, 6),
        "noise_multiplier": args.noise_multiplier, "delta": args.delta,
        "rounds": args.rounds, "epsilon": round(acc.epsilon(), 4),
        "trace": trace,
    }))


def cmd_transcribe(args):
    """Batch-transcribe WAV files (a file or a directory) without the CSV
    pipeline: audio -> InferenceEngine -> transcript + AD prediction per
    file, printed as one JSON row each (and written to ``--out`` as CSV).
    Greedy, or beam search with ``--beam_size``; returns the rows."""
    import csv

    from .data.audio import load_audio
    from .serving.engine import resolve_device

    device = resolve_device(args.device)
    src = Path(args.audio)
    paths = sorted(src.glob("**/*.wav")) if src.is_dir() else [src]
    if not paths:
        raise SystemExit(f"no .wav files under {src}")
    engine = _engine(args, device)
    results = engine.infer_batch([load_audio(str(p)) for p in paths])
    rows = [{"path": str(p), "transcript": r.transcript,
             "ad_pred": r.ad_pred, "ad_prob": round(r.ad_prob, 4)}
            for p, r in zip(paths, results)]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["path", "transcript", "ad_pred", "ad_prob"])
            w.writeheader()
            w.writerows(rows)
    for row in rows:
        print(json.dumps(row))
    return rows


def cmd_teacher(args):
    """Offline teacher-transcription pass (the reference's
    ``TeacherStudentLearning`` + transcript.json merge,
    federated/src/federated_main.py:29-68,283-298): transcribe the clips of
    an unlabeled CSV (``--train_csv``) and write a transcript JSON (path ->
    text) beside ``--out``, and at ``--out`` the labeled CSV
    ``federated --unsup_train_csv`` takes (empty transcripts dropped, as the
    reference's ``FilterAvailAudios`` does). The teacher is the package's
    own CTC model from ``-model_in`` (self-training, fp32 greedy), or with
    ``--whisper_hf <dir>`` an HF WhisperForConditionalGeneration checkpoint
    (``config.json``, ``pytorch_model.bin``, ``vocab.json`` and its added
    tokens; fp32, the six-temperature fallback, conditioning on the previous
    text, and the timestamp seek unless ``--no-timestamps``). Returns the
    path -> text map."""
    import csv

    from .serving.engine import resolve_device

    device = resolve_device(args.device)
    exs, tok = _load_examples(args, args.train_csv, with_transcript=False)
    if args.whisper_hf:
        from .data.teacher import WhisperTeacher
        from .data.whisper_tokens import WhisperDetokenizer
        from .models.whisper import WhisperConfigT

        d = Path(args.whisper_hf)
        with open(d / "config.json") as f:
            wcfg = WhisperConfigT.from_hf_config(json.load(f))
        sd = torch.load(d / "pytorch_model.bin", map_location="cpu", weights_only=True)
        teacher = WhisperTeacher(wcfg, sd, WhisperDetokenizer.from_pretrained(d),
                                 timestamps=args.timestamps, device=device)
        del sd
        trs = teacher.transcribe(exs, batch_size=args.eval_batch_size)
    else:
        from .data.teacher import transcribe_with_ctc_model

        cfg = _dacs_cfg(args)
        sd = load_weights(cfg, args.model_in_path, args.seed, device)
        trs = transcribe_with_ctc_model(cfg, sd, exs, tok, batch_size=args.eval_batch_size,
                                        device=device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".json"), "w") as f:
        json.dump(trs, f, indent=1)
    kept = 0
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["path", "sentence"])
        w.writeheader()
        for e in exs:
            text = (trs.get(e.path) or "").upper().strip()
            if text:
                w.writerow({"path": e.path, "sentence": text})
                kept += 1
    print(json.dumps({"transcribed": len(trs), "kept": kept,
                      "csv": str(out), "json": str(out.with_suffix('.json'))}))
    return trs


def cmd_export_hf(args):
    """Export the model's weights to an HF torch state_dict
    (pytorch_model.bin layout, ForCTC keys) so reference-style torch
    pipelines can load them (models/export.py)."""
    from .models.export import export_for_ctc_state_dict
    from .serving.engine import resolve_device

    cfg = _dacs_cfg(args)
    sd = load_weights(cfg, args.model_in_path, args.seed, resolve_device(args.device))
    out_sd = export_for_ctc_state_dict(sd, cfg.backbone,
                                       weight_norm_style=args.weight_norm_style)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(v.copy()) for k, v in out_sd.items()}, out)
    print(json.dumps({"keys": len(out_sd), "out": str(out)}))


def _load_rows(pkl: str) -> list[dict]:
    """An extraction pickle's rows, ``text`` defaulting to ``pred_str``."""
    from .evaluation import read_records

    rows = read_records(pkl)
    for r in rows:
        r.setdefault("text", r.get("pred_str"))
    return rows


def _load_bert_assets(args):
    """An HF ``BertModel`` checkpoint (``--bert_checkpoint``, with its
    ``config.json`` beside it where present) and ``--vocab`` ->
    (``BertEncoder`` state dict, BertConfigT, WordPieceTokenizer)."""
    from .text.bert import BertConfigT, WordPieceTokenizer, port_hf_bert

    sd = torch.load(args.bert_checkpoint, map_location="cpu", weights_only=True)
    n_layers = max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layer.")) + 1
    hidden = sd["embeddings.word_embeddings.weight"].shape[1]
    # geometry not derivable from the state dict: prefer the HF config.json
    # next to the checkpoint, else the standard head_dim=64 rule
    heads, cfg_json = None, Path(args.bert_checkpoint).parent / "config.json"
    if cfg_json.exists():
        with open(cfg_json) as f:
            heads = json.load(f).get("num_attention_heads")
    if heads is None:
        heads = (hidden // 64 if hidden % 64 == 0 and hidden >= 64
                 else max(h for h in (8, 4, 2, 1) if hidden % h == 0))
    bcfg = BertConfigT(
        vocab_size=sd["embeddings.word_embeddings.weight"].shape[0], hidden_size=hidden,
        num_hidden_layers=n_layers, num_attention_heads=heads,
        intermediate_size=sd["encoder.layer.0.intermediate.dense.weight"].shape[0],
        max_position_embeddings=sd["embeddings.position_embeddings.weight"].shape[0])
    return port_hf_bert(sd, bcfg), bcfg, WordPieceTokenizer.from_vocab_file(args.vocab)


def _build_bert_embed(args, device):
    """The BERT checkpoint as a frozen embedder on ``device``: texts ->
    pooled [N, hidden] (numpy), and its width."""
    from .text.bert import BertEncoder
    from .text.classifier import embed_sessions

    sd, bcfg, tok = _load_bert_assets(args)
    with torch.device("meta"):
        enc = BertEncoder(bcfg)
    enc.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True, assign=True)
    enc.eval()

    @torch.no_grad()
    def apply(ids, mask):
        return enc(torch.as_tensor(ids, device=device).long(),
                   torch.as_tensor(mask, device=device))[1].cpu().numpy()

    return (lambda texts: embed_sessions(apply, tok, texts)), bcfg.hidden_size


def cmd_text(args):
    """Text-branch AD classification over session documents assembled from
    extraction pickles (reference 0207_DM_* experiment scripts), on
    ``--device``. Embeddings: a BERT checkpoint (``--bert_checkpoint`` +
    ``--vocab``), frozen or fine-tuned end to end (``--finetune``), or a
    hashed bag of words; ``--experiment`` runs a registry experiment
    instead. Prints the test metrics as one JSON line and returns them."""
    import numpy as np

    from .serving.engine import resolve_device
    from .text import assemble_sessions
    from .text.classifier import TextClassifierConfig, TextTrainer, TextTrainerConfig

    from .parallel import dist as pdist

    if args.finetune and args.dp > 1:
        def check(have):
            if have < args.dp:
                raise ValueError(f"dp={args.dp} needs >= that many devices, have {have}")

        if not _run_here(args, args.dp, check):
            return None
    device = pdist.init_distributed(resolve_device(args.device))
    train_rows, test_rows = _load_rows(args.train_pkl), _load_rows(args.test_pkl)

    if args.experiment:  # named 0207_DM_* registry experiment
        from .text.experiments import EXPERIMENTS, TEXT_BACKENDS, run_experiment

        backends, ft_kw = None, {}
        if args.finetune:
            from .text.finetune import FinetuneTrainerConfig

            ft_kw = {"finetune": True, "ftcfg": FinetuneTrainerConfig(
                num_epochs=args.epochs, batch_size=args.train_batch_size,
                learning_rate=args.learning_rate or 2e-5, lr_schedule=args.lr_schedule,
                seed=args.seed, max_length=args.max_length, dp=args.dp)}
            if args.bert_checkpoint:   # fine-tune INTO the checkpoint
                params, bcfg, tok = _load_bert_assets(args)
                ft_kw.update(bert_cfg=bcfg, tokenizer=tok, encoder_params=params)
        elif args.bert_checkpoint:
            # frozen fast path: the checkpoint serves every TEXT backend
            embed, _ = _build_bert_embed(args, device)
            backends = {i.backend: embed for i in EXPERIMENTS[args.experiment].inputs
                        if i.backend in TEXT_BACKENDS}
        out = run_experiment(
            args.experiment, train_rows, test_rows, backends=backends,
            audio_root=args.audio_root,
            tcfg=TextTrainerConfig(num_epochs=args.epochs, batch_size=args.train_batch_size,
                                   learning_rate=args.learning_rate or 1e-3,
                                   lr_schedule=args.lr_schedule, seed=args.seed),
            seeds=tuple(range(args.seed, args.seed + 3)), device=device, **ft_kw)
        out = {"experiment": args.experiment, **out}
        if _lead():
            print(json.dumps(out))
        return out

    docs_train = assemble_sessions(train_rows, text_key=args.use_text)
    docs_test = assemble_sessions(test_rows, text_key=args.use_text)

    def labels_of(rows):
        return {r["path"].split("_")[0]: int(r["dementia_labels"]) for r in rows}

    y_train_map, y_test_map = labels_of(train_rows), labels_of(test_rows)
    sessions_train, sessions_test = sorted(docs_train), sorted(docs_test)
    xtr = [docs_train[s] for s in sessions_train]
    xte = [docs_test[s] for s in sessions_test]
    y_train = np.asarray([y_train_map[s] for s in sessions_train], dtype=np.int32)
    y_test = np.asarray([y_test_map[s] for s in sessions_test], dtype=np.int32)
    if args.finetune:
        # end to end: the encoder trains inside the graph (reference
        # SingleForwardModel; AdamW over all params)
        from .text.bert import BertConfigT, WordPieceTokenizer
        from .text.finetune import FinetuneConfig, FinetuneTextTrainer, FinetuneTrainerConfig

        enc_params = None
        if args.bert_checkpoint:
            enc_params, bcfg, tok = _load_bert_assets(args)
        else:
            tok = WordPieceTokenizer.from_corpus(xtr)
            bcfg = BertConfigT(vocab_size=max(len(tok.vocab), 8), hidden_size=128,
                               num_hidden_layers=4, num_attention_heads=4,
                               intermediate_size=256, max_position_embeddings=args.max_length)
        tr = FinetuneTextTrainer(
            FinetuneConfig(bert=bcfg), tok,
            FinetuneTrainerConfig(num_epochs=args.epochs, batch_size=args.train_batch_size,
                                  learning_rate=args.learning_rate or 2e-5,
                                  lr_schedule=args.lr_schedule, seed=args.seed,
                                  max_length=args.max_length, dp=args.dp),
            device=device)
        tr.fit([xtr], y_train, val_texts_per_input=[xte], val_labels=y_test,
               encoder_params=enc_params)
        out = {**{f"test_{k}": v for k, v in tr.evaluate([xte], y_test).items()},
               "mode": "finetune"}
        if _lead():
            print(json.dumps(out))
        return out

    if args.bert_checkpoint:
        embed, _ = _build_bert_embed(args, device)
    else:
        from .text.experiments import hash_embed_backend

        embed = hash_embed_backend(256)
    x_train, x_test = embed(xtr), embed(xte)
    tr = TextTrainer(
        TextClassifierConfig(embed_dim=x_train.shape[1], hidden_dim=args.hidden_dim),
        TextTrainerConfig(num_epochs=args.epochs, batch_size=args.train_batch_size,
                          learning_rate=args.learning_rate or 1e-3,
                          lr_schedule=args.lr_schedule, seed=args.seed),
        device=device)
    tr.fit(x_train, y_train, x_test, y_test)
    out = {"test_" + k: v for k, v in tr.evaluate(x_test, y_test).items()}
    print(json.dumps(out))
    return out


def cmd_sweep(args):
    """Replay the reference's run_*.sh sweep grids as one command
    (run_dementia_BERTparamsTuning.sh, run_dementia_SVM.sh,
    run_HyperparameterTune.sh — see sweep.py for the full mapping); returns
    the rows."""
    from .sweep import (
        ASR_PRESETS,
        SVM_PRESETS,
        TEXT_PRESETS,
        parse_grid,
        sweep_asr,
        sweep_svm,
        sweep_text,
    )

    presets = {"asr": ASR_PRESETS, "text": TEXT_PRESETS, "svm": SVM_PRESETS}[args.target]
    grid = presets[args.preset]() if args.preset else {}
    grid.update(parse_grid(args.grid))  # explicit --grid axes override presets
    if not grid:
        raise SystemExit(f"sweep {args.target}: give --preset "
                         f"({', '.join(sorted(presets))}) and/or --grid key=v1,v2")
    from .serving.engine import resolve_device

    device = resolve_device(args.device)
    if args.target == "text":
        return sweep_text(grid, _load_rows(args.train_pkl), _load_rows(args.test_pkl),
                          results_csv=args.results_csv, seed=args.seed, device=device)
    if args.target == "svm":
        from .data.dataset import load_spk2label

        return sweep_svm(grid, _load_rows(args.train_pkl), _load_rows(args.test_pkl),
                         load_spk2label(args.spk2label), results_csv=args.results_csv,
                         device=device)
    from .parallel import dist as pdist
    from .train.trainer import TrainerConfig, check_devices, validate_layout

    cfg = _dacs_cfg(args)
    tcfg = TrainerConfig(
        num_epochs=args.epochs, batch_size=args.train_batch_size,
        eval_batch_size=args.eval_batch_size, seed=args.seed,
        compute_dtype=args.compute_dtype, log_file=args.log_path,
        scan_layers=args.scan_layers, dp=args.dp, tp=args.tp)
    if not _run_here(args, validate_layout(cfg, tcfg), lambda have: check_devices(tcfg, have)):
        return None
    device = pdist.init_distributed(device)
    train_exs, tok = _load_examples(args, args.train_csv)
    test_exs, _ = _load_examples(args, args.test_csv)
    sd = load_weights(cfg, args.model_in_path, args.seed, device)
    return sweep_asr(grid, cfg, tcfg, sd, train_exs, test_exs, tok,
                     results_csv=args.results_csv if _lead() else None, device=device)


def _add_beam(p) -> None:
    """Beam decoding flags of ``serve``, ``extract`` and ``transcribe``."""
    p.add_argument("--beam_size", type=int, default=0,
                   help="0 = greedy (reference parity); >0 = CTC prefix beam search "
                        "(ops/beam.py)")
    p.add_argument("--lm_train_csv", default=None,
                   help="fit a char-bigram shallow-fusion LM on this train CSV's "
                        "transcripts (needs --beam_size > 0)")
    p.add_argument("--lm_alpha", type=float, default=0.3)
    p.add_argument("--lm_beta", type=float, default=0.0)


def _add_train(p) -> None:
    """The JAX ``_add_common`` flags (``--no_fast_rng``, which only switches
    the TPU's RNG, has no counterpart here), plus ``--device``."""
    p.add_argument("--model_type", default="data2vec", choices=sorted(BACKBONES))
    p.add_argument("--method", default="dacs", choices=METHODS)
    p.add_argument("-GRL", "--GRL", action="store_true", default=False,
                   help="method=grl: gradient-reversed AD CE")
    p.add_argument("-model_in", "--model_in_path", default=None,
                   help="port checkpoint or ForCTC torch state dict")
    p.add_argument("-model_out", "--model_out_path", default="./saves/model")
    p.add_argument("-log", "--log_path", default="train.txt")
    p.add_argument("-st", "--STAGE", type=int, default=0)
    p.add_argument("-lam", "--LAMBDA", type=float, default=0.5)
    p.add_argument("-gs_tau", "--GS_TAU", type=float, default=1.0)
    p.add_argument("-toggle_rt", "--TOGGLE_RATIO", type=float, default=0.0)
    p.add_argument("-ad_loss", "--AD_loss", default="cel")
    p.add_argument("-w_loss", "--W_LOSS", type=float, nargs="+", default=None)
    p.add_argument("--num_lms", type=int, default=1,
                   help="N-best multitask lm heads (lm_heads.{i}): trained at stage 0, "
                        "exported, read by the federated N-best phase")
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("-lr", "--learning_rate", type=float, default=None)
    p.add_argument("--eval_steps", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16", "int8"],
                   help="int8 (dynamic-W8A8 quantized matmuls, ops/quant.py) applies "
                        "to the inference surfaces only (extract/serve/transcribe); "
                        "training is fp32/bf16")
    p.add_argument("--int8", action="store_true",
                   help="int8-quantized training matmuls (dense_impl='int8_train': "
                        "W8A8 forward + SwitchBack gradients), a semantics change "
                        "against the reference")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--scan_layers", action="store_true")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=None)
    p.add_argument("--sp", type=int, default=1)
    # the reference's path.sh exports DACS_dataRoot/DACS_codeRoot
    dacs_data = os.environ.get("DACS_dataRoot", "./data")
    dacs_code = os.environ.get("DACS_codeRoot", ".")
    p.add_argument("--audio_dir", default=f"{dacs_data}/clips")
    p.add_argument("--train_csv", default=f"{dacs_data}/mid_csv/train.csv")
    p.add_argument("--test_csv", default=f"{dacs_data}/mid_csv/test.csv")
    p.add_argument("--spk2label", default=f"{dacs_code}/meta-data/test_dic.npy")
    p.add_argument("--dataset_cache", default="./dataset_cache")
    p.add_argument("-ckpt", "--checkpoint", default=None,
                   help="resume: a checkpoint dir of this port, or 'auto'")
    p.add_argument("--no_cache_encoder", action="store_true")
    p.add_argument("--no_cache_frontend", action="store_true",
                   help="stage 0: full forward from waveforms every step")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu only when asked for explicitly")


def _add_federated(p) -> None:
    """The JAX ``cli federated`` flags; the meshes and ``--fl_zero1`` are
    accepted and refused by the engine's config until the parallel slice."""
    p.add_argument("-fl_st", "--FL_STAGE", type=int, default=0,
                   help="1/2/3, or 0 = full pipeline")
    p.add_argument("--epochs", type=int, default=10, help="FL rounds")
    p.add_argument("--num_users", type=int, default=2)
    p.add_argument("--frac", type=float, default=1.0)
    p.add_argument("--local_ep", type=int, default=5)
    p.add_argument("--global_ep", type=int, default=30)
    p.add_argument("-sl", "--supervised_level", type=float, default=1.0)
    p.add_argument("--unsup_train_csv", default=None,
                   help="unlabeled (teacher-transcribed) client data for "
                        "supervised_level < 1 (reference: ADReSSo)")
    p.add_argument("--dp_clip_norm", type=float, default=None,
                   help="DP-FedAvg: clip client update deltas to this L2 norm")
    p.add_argument("--dp_noise_multiplier", type=float, default=0.0,
                   help="DP-FedAvg: Gaussian noise std = clip * this / K")
    p.add_argument("--dp_delta", type=float, default=1e-5,
                   help="delta of the reported (epsilon, delta) guarantee")
    p.add_argument("--client_mesh", type=int, default=1)
    p.add_argument("--data_mesh", type=int, default=1)
    p.add_argument("--num_slices", type=int, default=0)
    p.add_argument("--fl_zero1", action="store_true")
    p.add_argument("--model_mesh", type=int, default=1)
    p.add_argument("--fedprox_mu", type=float, default=0.0)
    p.add_argument("--server_optimizer", default="none",
                   choices=["none", "momentum", "adam"])
    p.add_argument("--server_lr", type=float, default=None)
    p.add_argument("--server_momentum", type=float, default=0.9)
    p.add_argument("--compress_bits", type=int, default=None)
    p.add_argument("--secagg_clip_norm", type=float, default=None)
    p.add_argument("--secagg_bits", type=int, default=20)
    p.add_argument("--topk_fraction", type=float, default=None)
    p.add_argument("--round_save_dir", default=None,
                   help="save the global params after every round and resume "
                        "from the newest round checkpoint on restart")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="privacy_preserve_federated_asr_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="centralized training (any stage/recipe)")
    _add_train(p)
    p.add_argument("--epochs", type=int, default=30)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("federated", help="federated 3-stage pipeline")
    _add_train(p)
    _add_federated(p)
    p.set_defaults(fn=cmd_federated)

    p = sub.add_parser("serve", help="batched ASR+AD inference server on the GPU")
    _add_train(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--max_seconds", type=float, default=30.0)
    p.add_argument("--batch_window_ms", type=float, default=10.0)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running one batch per time bucket at startup")
    _add_beam(p)
    p.add_argument("--transport", default="float32", choices=["float32", "int16"],
                   help="host->device waveform encoding; int16 halves the upload "
                        "bytes (dequantization and normalization on the card)")
    p.add_argument("--no_hub", action="store_true",
                   help="standalone streaming sessions instead of the shared "
                        "StreamingHub (one batched pass per hop for every stream)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("stream-client",
                       help="stream a WAV to a running `serve` over the binary PCM "
                            "transport, printing partials")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--audio", default=None,
                   help="WAV path (any rate; resampled to 16 kHz); omitted = "
                        "synthetic noise smoke input")
    p.add_argument("--chunk_seconds", type=float, default=0.5)
    p.add_argument("--synthetic_seconds", type=float, default=3.0)
    p.add_argument("--json_transport", action="store_true",
                   help="send JSON float lists instead of binary PCM (debugging)")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_stream_client)

    p = sub.add_parser("stream-report",
                       help="streaming finalization flip rate per right-context "
                            "setting on the test CSV's audio "
                            "(serving/streaming.py measure_finalization_flips)")
    _add_train(p)
    p.add_argument("--max_seconds", type=float, default=30.0)
    p.add_argument("--max_utts", type=int, default=0,
                   help="cap the measured utterances (0 = all)")
    p.add_argument("--hop_seconds", type=float, default=0.5)
    p.add_argument("--right_context_grid", type=float, nargs="+",
                   default=[0.25, 0.5, 1.0, 2.0, 4.0])
    p.set_defaults(fn=cmd_stream_report)

    p = sub.add_parser("extract", help="dump embeddings/masks/transcripts")
    _add_train(p)
    p.add_argument("-csv", "--csv_name", default="extract")
    p.add_argument("--csv_out_dir", default="./saves/results")
    _add_beam(p)
    # reference extraction runs fp32 (no .half() in the eval scripts);
    # opt into bf16 explicitly for speed
    p.set_defaults(fn=cmd_extract, compute_dtype="float32")

    p = sub.add_parser("detail-wer", help="grouped WER report")
    p.add_argument("--pkl", required=True)
    p.add_argument("-t", "--type", type=int, default=2, choices=[1, 2, 3])
    p.add_argument("--id2mmse", default=None)
    p.add_argument("--out_dir", default=None)
    p.set_defaults(fn=cmd_detail_wer)

    p = sub.add_parser("svm", help="SVM AD prediction with speaker vote")
    p.add_argument("--train_pkl", required=True)
    p.add_argument("--test_pkl", required=True)
    p.add_argument("--spk2label", default="./meta-data/test_dic.npy")
    p.add_argument("-sq", "--squeeze", default="min",
                   choices=["mean", "min", "max", "median"])
    p.add_argument("--mode", default="audio", choices=["audio", "text", "fusion"])
    p.add_argument("--masked", action="store_true")
    p.add_argument("-INV", "--INV", action="store_true")
    p.add_argument("--text_train_pkl", default=None)
    p.add_argument("--text_test_pkl", default=None)
    p.add_argument("--results_csv", default="./saves/results/SVM/results.csv")
    p.add_argument("--title", default="dacs_tpu")
    p.add_argument("--device", default="cuda",
                   help="torch device of the scaler and the SVC; cpu only when asked")
    p.set_defaults(fn=cmd_svm)

    p = sub.add_parser("pkl2csv", help="extraction pkl -> text-columns CSV")
    p.add_argument("--pkl", required=True)
    p.add_argument("--out", default=None, help="default: <pkl>.csv")
    p.set_defaults(fn=cmd_pkl2csv)

    p = sub.add_parser("feat-scoring", help="mask statistics")
    p.add_argument("--pkl", required=True)
    p.add_argument("--out_dir", default="./saves/results/FSM_info")
    p.set_defaults(fn=cmd_feat_scoring)

    p = sub.add_parser("dp-budget",
                       help="plan DP-FedAvg (epsilon, delta) before a run "
                            "(RDP accountant, no compute)")
    p.add_argument("--rounds", type=int, required=True,
                   help="total noised FedAvg rounds (sum over stages)")
    p.add_argument("--num_users", type=int, default=54)
    p.add_argument("--frac", type=float, default=1.0)
    p.add_argument("--noise_multiplier", type=float, default=None,
                   help="forward mode: epsilon for this noise level")
    p.add_argument("--target_epsilon", type=float, default=None,
                   help="inverse mode: smallest noise multiplier reaching "
                        "this epsilon (exclusive with --noise_multiplier)")
    p.add_argument("--delta", type=float, default=1e-5)
    p.add_argument("--report_every", type=int, default=1,
                   help="trace granularity in rounds")
    p.set_defaults(fn=cmd_dp_budget)

    p = sub.add_parser("transcribe",
                       help="batch-transcribe WAV file(s) without the CSV "
                            "pipeline (ASR transcript + AD prediction)")
    _add_train(p)
    p.add_argument("--audio", required=True,
                   help="a .wav file or a directory (searched recursively)")
    p.add_argument("--out", default=None, help="optional output CSV")
    p.add_argument("--max_seconds", type=float, default=30.0)
    _add_beam(p)
    p.set_defaults(fn=cmd_transcribe)

    p = sub.add_parser("teacher",
                       help="offline teacher transcription: label an unlabeled CSV "
                            "(--train_csv) with the model's transcripts")
    _add_train(p)
    p.add_argument("--out", required=True,
                   help="output CSV path (path,sentence: feed to `federated "
                        "--unsup_train_csv`); a transcript JSON is written beside it")
    p.add_argument("--whisper_hf", default=None,
                   help="HF WhisperForConditionalGeneration checkpoint dir (config.json, "
                        "pytorch_model.bin, vocab.json and its added tokens); default "
                        "teacher is this package's CTC model from -model_in")
    p.add_argument("--timestamps", action=argparse.BooleanOptionalAction, default=True,
                   help="whisper teacher only: decode with timestamp tokens and advance "
                        "windows by the last predicted segment boundary (upstream "
                        "whisper.transcribe's default); --no-timestamps: fixed 30 s hops")
    p.set_defaults(fn=cmd_teacher)

    p = sub.add_parser("text", help="text-branch AD classifier over session docs")
    p.add_argument("--train_pkl", required=True)
    p.add_argument("--test_pkl", required=True)
    p.add_argument("--use_text", default="text", choices=["text", "pred_str"])
    p.add_argument("--experiment", default=None,
                   help="named 0207_DM_* experiment from the registry "
                        "(text/experiments.py); overrides the plain path")
    p.add_argument("--bert_checkpoint", default=None,
                   help="HF BertModel state dict (pytorch_model.bin)")
    p.add_argument("--vocab", default=None, help="its WordPiece vocab.txt")
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("-lr", "--learning_rate", type=float, default=None)
    p.add_argument("--lr_schedule", default="lin", choices=["exp", "lin", "cos"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--finetune", action="store_true",
                   help="train the BERT encoder inside the graph (AdamW over all "
                        "params, the reference SingleForwardModel setup) instead of the "
                        "frozen-embedding head")
    p.add_argument("--max_length", type=int, default=128,
                   help="finetune: static token length per example")
    p.add_argument("--dp", type=int, default=1,
                   help="finetune: data-parallel devices (one rank each)")
    p.add_argument("--audio_root", default=None,
                   help="resolve audio InputSpecs (en/gr/multi/wv) against this "
                        "directory and embed the waveforms through the SSL conv frontend")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu only when asked for explicitly")
    p.set_defaults(fn=cmd_text)

    p = sub.add_parser("export-hf",
                       help="model weights -> HF torch state_dict "
                            "(pytorch_model.bin) for reference-world use")
    _add_train(p)
    p.add_argument("--out", default="./saves/export/pytorch_model.bin")
    p.add_argument("--weight_norm_style", default="parametrizations",
                   choices=["parametrizations", "legacy"],
                   help="pos-conv weight-norm key layout (torch>=2 modules "
                        "use parametrizations.*; older checkpoints "
                        "weight_g/weight_v)")
    p.set_defaults(fn=cmd_export_hf)

    p = sub.add_parser("sweep", help="replay the reference run_*.sh sweep grids")
    sweep_sub = p.add_subparsers(dest="target", required=True)
    sp = sweep_sub.add_parser("asr", help="ASR/DACS hyperparameter grid "
                              "(run_HyperparameterTune.sh)")
    _add_train(sp)
    sp.add_argument("--epochs", type=int, default=5)
    sp.add_argument("--preset", default=None, choices=["hyperparameter-tune"])
    sp.add_argument("--grid", nargs="*", default=[], metavar="key=v1,v2",
                    help="DACSConfig/TrainerConfig axes, e.g. gs_tau=0.5,1.0")
    sp.add_argument("--results_csv", default="./saves/results/sweep/asr_results.csv")
    sp.set_defaults(fn=cmd_sweep, target="asr")
    for name, choices, hlp in (
        ("text", ["bert", "bert-regression", "bert-params-tuning"],
         "text-branch grids (run_dementia_BERT*.sh)"),
        ("svm", ["dementia-svm"], "SVM grids (run_dementia_SVM.sh)"),
    ):
        sp = sweep_sub.add_parser(name, help=hlp)
        sp.add_argument("--train_pkl", required=True)
        sp.add_argument("--test_pkl", required=True)
        sp.add_argument("--preset", default=None, choices=choices)
        sp.add_argument("--grid", nargs="*", default=[], metavar="key=v1,v2")
        sp.add_argument("--spk2label", default="./meta-data/test_dic.npy")
        sp.add_argument("--results_csv",
                        default=f"./saves/results/sweep/{name}_results.csv")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default="cuda",
                        help="torch device; cpu only when asked for explicitly")
        sp.set_defaults(fn=cmd_sweep, target=name)
    return parser


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    args.argv = argv
    return args.fn(args)


if __name__ == "__main__":
    main()
