"""Command-line interface of the port: ``train``, ``federated``, ``serve``,
``extract``, ``svm``, ``detail-wer``, ``feat-scoring``, ``pkl2csv`` and
``dp-budget`` (the JAX package's subcommands of those names, same flag
names).

    python -m privacy_preserve_federated_asr_tpu_torch.cli train \
        --model_type data2vec -st 0 --epochs 30 --audio_dir ... \
        --train_csv ... --test_csv ... --spk2label ... -model_out ./saves/model
    python -m privacy_preserve_federated_asr_tpu_torch.cli federated \
        --model_type data2vec -fl_st 0 --num_users 2 --epochs 10 --local_ep 5 \
        --global_ep 30 --audio_dir ... --train_csv ... --test_csv ... \
        --spk2label ... -model_out ./saves/model
    python -m privacy_preserve_federated_asr_tpu_torch.cli serve \
        --model_type data2vec --STAGE 2 --port 8008 [--model_in ckpt.bin]
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

``--model_in`` takes a port checkpoint (a ``final/`` export or a
``checkpoint-<step>/`` directory of ``train``), or a ForCTC torch state dict
as the JAX package's ``cli export-hf`` writes it (or an HF encoder/ForCTC
``pytorch_model.bin``); heads the file lacks keep their random init. Without
it the weights are a random init from ``--seed``. Every command that runs a
model or the SVM runs on ``--device`` (default ``cuda``; with no GPU it
exits with an error rather than run on the CPU). ``federated`` writes
``<model_out>_FLASR_global/final``, ``<model_out>_FLAD_global/final`` and
``<model_out>_final_global/final`` (per ``-fl_st``), each loadable with
``--model_in``. ``extract`` writes ``<csv_name>.pkl`` (test CSV),
``<csv_name>_train.pkl`` and the test set's ``Result.csv``; the analysis
commands read those pickles without pandas (``evaluation/extract.py``).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

BACKBONES = {
    "data2vec": "data2vec_audio_large",
    "data2vec-base": "data2vec_audio_base",
    "wav2vec2": "wav2vec2_large_960h_lv60",
    "wav2vec2-base": "wav2vec2_base_960h",
    "hubert": "hubert_large_ls960",
    "unispeech": "unispeech_sat_large",
    "tiny": "tiny_for_tests",  # smoke tests
}


def _dacs_cfg(args):
    from .models import BackboneConfig, DACSConfig

    train = dict(lambda_grl=args.LAMBDA, ad_loss=args.AD_loss,
                 w_loss=tuple(args.W_LOSS) if args.W_LOSS else (0.1, 0.9),
                 grl_reverse=args.GRL) if args.cmd in ("train", "federated") else {}
    return DACSConfig(
        backbone=getattr(BackboneConfig, BACKBONES[args.model_type])(),
        method=args.method,
        stage=args.STAGE,
        gs_tau=args.GS_TAU,
        toggle_ratio=args.TOGGLE_RATIO,
        **train,
    )


def load_weights(cfg, model_in: str | None, seed: int = 0,
                 device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """DACSModel weights: a seeded random init (generator on ``device``),
    with a port checkpoint or a torch checkpoint's encoder and heads carried
    over it when ``model_in`` is given."""
    from .models import init_dacs_state_dict, state_dict_from_hf
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
    if path.is_dir():
        path = path / "pytorch_model.bin"
    print(f"[init] torch checkpoint {path}")
    ported = state_dict_from_hf(torch.load(str(path), map_location="cpu",
                                           weights_only=True), cfg)
    for k, v in ported.items():
        if v.shape != sd[k].shape:
            raise ValueError(f"checkpoint {k} has shape {tuple(v.shape)}, the "
                             f"model {tuple(sd[k].shape)} (wrong --model_type?)")
        sd[k] = v
    return sd


def cmd_serve(args):
    from .data.tokenizer import CTCCharTokenizer
    from .serving import InferenceEngine, ServingConfig, serve_forever
    from .serving.engine import resolve_device

    device = resolve_device(args.device)
    cfg = _dacs_cfg(args)
    engine = InferenceEngine(
        cfg, load_weights(cfg, args.model_in_path, args.seed, device),
        CTCCharTokenizer(),
        ServingConfig(batch_size=args.eval_batch_size,
                      max_seconds=args.max_seconds,
                      batch_window_ms=args.batch_window_ms,
                      compute_dtype=args.compute_dtype),
        device=device)
    serve_forever(engine, host=args.host, port=args.port,
                  warmup=not args.no_warmup)


def _load_examples(args, csv_path):
    from .data.dataset import csv_to_examples, load_spk2label, prepare_examples
    from .data.tokenizer import CTCCharTokenizer

    tok = CTCCharTokenizer()
    spk2label = load_spk2label(args.spk2label) if args.spk2label else {}
    exs = csv_to_examples(args.audio_dir, csv_path, spk2label,
                          cache_dir=args.dataset_cache)
    return prepare_examples(exs, tok), tok


def cmd_train(args):
    """Train, then print the final evaluation; returns the Trainer."""
    from .serving.engine import resolve_device
    from .train.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = _dacs_cfg(args)
    train_exs, tok = _load_examples(args, args.train_csv)
    test_exs, _ = _load_examples(args, args.test_csv)
    sd = load_weights(cfg, args.model_in_path, args.seed, device)
    tr = Trainer(cfg, sd, train_exs, test_exs, tok, TrainerConfig(
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
        resume_from=args.checkpoint), device=device)
    tr.train()
    print(json.dumps(tr.evaluate()))
    return tr


def cmd_federated(args):
    """The 3-stage FedAvg pipeline, then print the final evaluation; returns
    the FederatedEngine."""
    from .data.splits import CLIENT_SPLITS_ADRESS, filter_by_speakers
    from .federated import FederatedConfig, FederatedEngine
    from .serving.engine import resolve_device
    from .train.checkpoint import save_params

    device = resolve_device(args.device)
    if args.num_lms > 1:
        raise NotImplementedError("federated options not ported yet: num_lms > 1")
    if args.scan_layers or args.dp > 1 or args.tp > 1:
        print("[federated] note: --scan_layers/--dp/--tp apply to `train` only; FL "
              "parallelism is the engine's (client, data) mesh (FederatedConfig.mesh)")
    meshes = (args.client_mesh, args.data_mesh, args.model_mesh)
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
        mesh=meshes if max(meshes) > 1 or args.num_slices else None,
        zero1=args.fl_zero1, tp=args.model_mesh > 1)

    cfg = _dacs_cfg(args)
    train_exs, tok = _load_examples(args, args.train_csv)
    test_exs, _ = _load_examples(args, args.test_csv)
    sd = load_weights(cfg, args.model_in_path, args.seed, device)
    clients = {cid: filter_by_speakers(train_exs, CLIENT_SPLITS_ADRESS.get(cid, ()))
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
    eng = FederatedEngine(cfg, fcfg, clients, public, test_exs, tok, sd, device=device)
    del sd
    out = str(Path(args.model_out_path))
    for fl_stage, run, name in ((1, eng.run_stage1, "FLASR"), (2, eng.run_stage2, "FLAD"),
                                (3, eng.run_stage3, "final")):
        if args.FL_STAGE in (fl_stage, 0):
            run()
            save_params(f"{out}_{name}_global/final", eng.global_params,
                        {"fl_stage": fl_stage})
    print(json.dumps(eng.evaluate(stage=min(max(args.FL_STAGE - 1, 0), 2))))
    return eng


def cmd_extract(args):
    """Extraction rows of the test and train CSVs: ``<csv_name>.pkl``,
    ``<csv_name>_train.pkl`` and the test set's ``Result.csv``."""
    from .evaluation import extract_embeddings, rows_to_pickle, write_results_csv
    from .serving.engine import resolve_device

    device = resolve_device(args.device)
    if args.dp > 1:
        raise NotImplementedError("extract --dp > 1 (data-parallel extraction) is not "
                                  "ported yet")
    if args.beam_size > 0 or args.lm_train_csv:
        raise NotImplementedError("extract --beam_size > 0 / --lm_train_csv (beam "
                                  "search) is not ported yet")
    cfg = _dacs_cfg(args)
    sd = load_weights(cfg, args.model_in_path, args.seed, device)
    out_dir = Path(args.csv_out_dir)
    for split, csv_path in (("", args.test_csv), ("_train", args.train_csv)):
        exs, tok = _load_examples(args, csv_path)
        rows = extract_embeddings(cfg, sd, exs, tok, batch_size=args.eval_batch_size,
                                  compute_dtype=args.compute_dtype, device=device)
        rows_to_pickle(rows, str(out_dir / f"{args.csv_name}{split}.pkl"))
        if split == "":  # the reference writes Result.csv for the test set
            write_results_csv(rows, str(out_dir))
        print(f"[extract] wrote {len(rows)} rows -> {out_dir}/{args.csv_name}{split}.pkl")


def cmd_svm(args):
    from .data.dataset import load_spk2label
    from .evaluation import predict_ad_svm, read_records
    from .serving.engine import resolve_device

    device = resolve_device(args.device)
    if args.text_train_pkl or args.text_test_pkl:
        raise NotImplementedError("svm --text_train_pkl/--text_test_pkl (session text "
                                  "embeddings) is not ported yet")
    m = predict_ad_svm(
        read_records(args.train_pkl), read_records(args.test_pkl),
        load_spk2label(args.spk2label), pooling=args.squeeze, masked=args.masked,
        mode=args.mode, par_only=not args.INV, results_csv=args.results_csv,
        title=args.title, device=device)
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


def _add_train(p) -> None:
    """The JAX ``_add_common`` flags the port's Trainer takes (the
    parallelism and layout flags are accepted and refused by the Trainer
    until they are ported), plus ``--device``."""
    p.add_argument("--model_type", default="data2vec", choices=sorted(BACKBONES))
    p.add_argument("--method", default="dacs", choices=["dacs", "toggle_more", "grl"])
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
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("-lr", "--learning_rate", type=float, default=None)
    p.add_argument("--eval_steps", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
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
    """The JAX ``cli federated`` flags; those of options not ported yet are
    accepted and refused by the engine's config (or here: ``--num_lms``)."""
    p.add_argument("--num_lms", type=int, default=1)
    p.add_argument("-fl_st", "--FL_STAGE", type=int, default=0,
                   help="1/2/3, or 0 = full pipeline")
    p.add_argument("--epochs", type=int, default=10, help="FL rounds")
    p.add_argument("--num_users", type=int, default=2)
    p.add_argument("--frac", type=float, default=1.0)
    p.add_argument("--local_ep", type=int, default=5)
    p.add_argument("--global_ep", type=int, default=30)
    p.add_argument("-sl", "--supervised_level", type=float, default=1.0)
    p.add_argument("--unsup_train_csv", default=None,
                   help="unlabeled client data for supervised_level < 1 (not ported)")
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
    p.add_argument("--model_type", default="data2vec", choices=sorted(BACKBONES))
    p.add_argument("--method", default="dacs", choices=["dacs", "toggle_more", "grl"])
    p.add_argument("-model_in", "--model_in_path", default=None,
                   help="ForCTC torch state dict (JAX `cli export-hf` output)")
    p.add_argument("-st", "--STAGE", type=int, default=0)
    p.add_argument("-gs_tau", "--GS_TAU", type=float, default=1.0)
    p.add_argument("-toggle_rt", "--TOGGLE_RATIO", type=float, default=0.0)
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu only when asked for explicitly")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--max_seconds", type=float, default=30.0)
    p.add_argument("--batch_window_ms", type=float, default=10.0)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running one batch per time bucket at startup")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("extract", help="dump embeddings/masks/transcripts")
    _add_train(p)
    p.add_argument("-csv", "--csv_name", default="extract")
    p.add_argument("--csv_out_dir", default="./saves/results")
    p.add_argument("--beam_size", type=int, default=0,
                   help="0 = greedy (reference parity); beam search is not ported yet")
    p.add_argument("--lm_train_csv", default=None,
                   help="shallow-fusion LM for beam search (not ported yet)")
    p.add_argument("--lm_alpha", type=float, default=0.3)
    p.add_argument("--lm_beta", type=float, default=0.0)
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
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
