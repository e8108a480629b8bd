"""Command-line interface of the port: ``serve`` (the JAX package's
``cli serve``).

    python -m privacy_preserve_federated_asr_tpu_torch.cli serve \
        --model_type data2vec --STAGE 2 --port 8008 [--model_in ckpt.bin]

``--model_in`` takes a ForCTC torch state dict as the JAX package's
``cli export-hf`` writes it (or an HF encoder/ForCTC ``pytorch_model.bin``);
heads the file lacks keep their random init. Without it the weights are a
random init from ``--seed``. The server runs on ``--device`` (default
``cuda``; with no GPU it exits with an error rather than run on the CPU).
"""

from __future__ import annotations

import argparse
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

    return DACSConfig(
        backbone=getattr(BackboneConfig, BACKBONES[args.model_type])(),
        method=args.method,
        stage=args.STAGE,
        gs_tau=args.GS_TAU,
        toggle_ratio=args.TOGGLE_RATIO,
    )


def load_weights(cfg, model_in: str | None, seed: int = 0,
                 device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """DACSModel weights: a seeded random init (generator on ``device``),
    with a torch checkpoint's encoder and heads carried over it when
    ``model_in`` is given."""
    from .models import init_dacs_state_dict, state_dict_from_hf

    gen = torch.Generator(device).manual_seed(seed)
    sd = init_dacs_state_dict(cfg, gen)
    if not model_in:
        print("[init] random init (no --model_in given)")
        return sd
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="privacy_preserve_federated_asr_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

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


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
