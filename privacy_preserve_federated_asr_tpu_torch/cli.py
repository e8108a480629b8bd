"""Command-line interface of the port: ``train`` and ``serve`` (the JAX
package's ``cli train`` and ``cli serve``, same flag names).

    python -m privacy_preserve_federated_asr_tpu_torch.cli train \
        --model_type data2vec -st 0 --epochs 30 --audio_dir ... \
        --train_csv ... --test_csv ... --spk2label ... -model_out ./saves/model
    python -m privacy_preserve_federated_asr_tpu_torch.cli serve \
        --model_type data2vec --STAGE 2 --port 8008 [--model_in ckpt.bin]

``--model_in`` takes a port checkpoint (a ``final/`` export or a
``checkpoint-<step>/`` directory of ``train``), or a ForCTC torch state dict
as the JAX package's ``cli export-hf`` writes it (or an HF encoder/ForCTC
``pytorch_model.bin``); heads the file lacks keep their random init. Without
it the weights are a random init from ``--seed``. Both commands run on
``--device`` (default ``cuda``; with no GPU they exit with an error rather
than run on the CPU).
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
                 grl_reverse=args.GRL) if args.cmd == "train" else {}
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


def _add_train(p) -> None:
    """The JAX ``_add_common`` flags the port's Trainer takes (the
    parallelism and layout flags are accepted and refused by the Trainer
    until they are ported), plus ``--epochs`` and ``--device``."""
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
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu only when asked for explicitly")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="privacy_preserve_federated_asr_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="centralized training (any stage/recipe)")
    _add_train(p)
    p.set_defaults(fn=cmd_train)

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
