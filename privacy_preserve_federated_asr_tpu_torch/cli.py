"""Command-line interface of the port: ``train``, ``federated`` and
``serve`` (the JAX package's subcommands of those names, same flag names).

    python -m privacy_preserve_federated_asr_tpu_torch.cli train \
        --model_type data2vec -st 0 --epochs 30 --audio_dir ... \
        --train_csv ... --test_csv ... --spk2label ... -model_out ./saves/model
    python -m privacy_preserve_federated_asr_tpu_torch.cli federated \
        --model_type data2vec -fl_st 0 --num_users 2 --epochs 10 --local_ep 5 \
        --global_ep 30 --audio_dir ... --train_csv ... --test_csv ... \
        --spk2label ... -model_out ./saves/model
    python -m privacy_preserve_federated_asr_tpu_torch.cli serve \
        --model_type data2vec --STAGE 2 --port 8008 [--model_in ckpt.bin]

``--model_in`` takes a port checkpoint (a ``final/`` export or a
``checkpoint-<step>/`` directory of ``train``), or a ForCTC torch state dict
as the JAX package's ``cli export-hf`` writes it (or an HF encoder/ForCTC
``pytorch_model.bin``); heads the file lacks keep their random init. Without
it the weights are a random init from ``--seed``. Every command runs on
``--device`` (default ``cuda``; with no GPU it exits with an error rather
than run on the CPU). ``federated`` writes ``<model_out>_FLASR_global/final``,
``<model_out>_FLAD_global/final`` and ``<model_out>_final_global/final``
(per ``-fl_st``), each loadable with ``--model_in``.
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
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
