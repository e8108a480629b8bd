#!/usr/bin/env python
"""One unattended system run of the port (the twin of scripts/system_run.py).

Runs the whole system end to end through the port's CLI — synthetic data
(scripts/make_synthetic_data.py) -> the 3-stage federated pipeline (``cli
federated -fl_st 0``) -> extraction from the final global model -> SVM AD
prediction -> detail-WER -> mask statistics — and writes a JSON report with
each stage's wall clock, return code and last JSON line.

Each stage runs in its own subprocess, so a stage that fails or hangs
degrades to an error field instead of ending the run.

Usage (from anywhere; paths default to saves/, which git ignores):
    python privacy_preserve_federated_asr_tpu_torch/tools/system_run.py
        # on the GPU, data2vec-audio-large
    python privacy_preserve_federated_asr_tpu_torch/tools/system_run.py \
        --model_type tiny --device cpu      # a CPU rehearsal
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def run_stage(name: str, argv: list[str], timeout_s: float, log_dir: Path) -> dict:
    """Run one stage; record wall clock, return code, and the last JSON
    line it printed (the CLI's metric convention)."""
    t0 = time.perf_counter()
    log = log_dir / f"{name}.log"
    try:
        with open(log, "w") as f:
            rc = subprocess.run(argv, stdout=f, stderr=subprocess.STDOUT,
                                timeout=timeout_s, cwd=str(REPO)).returncode
    except subprocess.TimeoutExpired:
        rc = -1
    wall = time.perf_counter() - t0
    lines = log.read_text().splitlines()
    last_json = None
    for line in reversed(lines):
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                last_json = json.loads(line)
                break
            except json.JSONDecodeError:
                continue
    row = {"wall_s": round(wall, 1), "rc": rc}
    if rc != 0:
        row["error"] = " | ".join(lines[-5:])[:400]
    if last_json is not None:
        row["output"] = last_json
    print(f"[system_run] {name}: rc={rc} wall={wall:.1f}s", flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "saves/system_run_torch"))
    ap.add_argument("--json", default=None, help="default: <out>/system_run.json")
    ap.add_argument("--model_type", default="data2vec",
                    help="data2vec-audio-large by default; 'tiny' for a CPU rehearsal")
    ap.add_argument("--device", default="cuda", help="cpu only when asked for")
    ap.add_argument("--rounds", type=int, default=1, help="FL rounds per stage")
    ap.add_argument("--num_users", type=int, default=2)
    ap.add_argument("--local_ep", type=int, default=1)
    ap.add_argument("--global_ep", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--speakers", type=int, default=6)
    ap.add_argument("--utts", type=int, default=3)
    ap.add_argument("--stage_timeout_s", type=float, default=3600.0)
    args = ap.parse_args()

    out = Path(args.out).resolve()
    if out.exists():
        shutil.rmtree(out)
    (out / "logs").mkdir(parents=True)
    report_path = Path(args.json) if args.json else out / "system_run.json"
    dtype = "float32" if args.device == "cpu" else "bfloat16"

    py = sys.executable
    cli = [py, "-m", "privacy_preserve_federated_asr_tpu_torch.cli"]
    common = [
        "--model_type", args.model_type,
        "--audio_dir", f"{out}/data/clips",
        "--train_csv", f"{out}/data/train.csv",
        "--test_csv", f"{out}/data/test.csv",
        "--spk2label", f"{out}/data/spk2label.npy",
        "--dataset_cache", f"{out}/cache",
        "--compute_dtype", dtype,
        "--train_batch_size", str(args.batch),
        "--eval_batch_size", str(args.batch),
        "--device", args.device,
    ]
    stages: list[tuple[str, list[str]]] = [
        ("synthetic_data",
         [py, "scripts/make_synthetic_data.py", "--out", f"{out}/data",
          "--speakers", str(args.speakers), "--utts_per_speaker", str(args.utts)]),
        ("federated_pipeline",
         cli + ["federated", "-fl_st", "0", "--epochs", str(args.rounds),
                "--num_users", str(args.num_users), "--local_ep", str(args.local_ep),
                "--global_ep", str(args.global_ep), "-model_out", f"{out}/model",
                "-log", "system_run.txt"] + common),
        ("extract",
         cli + ["extract", "-st", "2", "-model_in", f"{out}/model_final_global/final",
                "-csv", "systemrun", "--csv_out_dir", f"{out}/results"] + common),
        ("svm",
         cli + ["svm", "--train_pkl", f"{out}/results/systemrun_train.pkl",
                "--test_pkl", f"{out}/results/systemrun.pkl",
                "--spk2label", f"{out}/data/spk2label.npy", "-sq", "mean",
                "--results_csv", f"{out}/results/SVM/results.csv",
                "--device", args.device]),
        ("detail_wer",
         cli + ["detail-wer", "--pkl", f"{out}/results/systemrun.pkl", "-t", "2",
                "--out_dir", f"{out}/wer"]),
        ("feat_scoring",
         cli + ["feat-scoring", "--pkl", f"{out}/results/systemrun.pkl",
                "--out_dir", f"{out}/fsm_info"]),
    ]

    t0 = time.perf_counter()
    report: dict = {
        "device": args.device,
        "model_type": args.model_type,
        "shape": (f"K={args.num_users} rounds={args.rounds} local_ep={args.local_ep} "
                  f"B={args.batch} {args.speakers}spk x {args.utts}utt"),
        "stages": {},
    }
    ok = True
    for name, argv in stages:
        row = run_stage(name, argv, args.stage_timeout_s, out / "logs")
        report["stages"][name] = row
        if row["rc"] != 0:
            ok = False
            break
    report["total_wall_s"] = round(time.perf_counter() - t0, 1)
    report["ok"] = ok
    svm = report["stages"].get("svm", {}).get("output")
    if isinstance(svm, dict):
        report["svm_metrics"] = svm
    report_path.parent.mkdir(parents=True, exist_ok=True)
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"ok": ok, "total_wall_s": report["total_wall_s"],
                      "json": str(report_path)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
