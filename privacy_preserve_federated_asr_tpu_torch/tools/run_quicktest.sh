#!/usr/bin/env bash
# End-to-end smoke driver of the port (the twin of scripts/run_quicktest.sh):
# synthetic data -> stage-0 train -> stage-2 extract -> SVM + detail-WER +
# mask statistics, through the port's CLI.
#
#   privacy_preserve_federated_asr_tpu_torch/tools/run_quicktest.sh [OUT]
#
# Runs on the GPU with data2vec-audio-base (the CUDA attention kernels take
# heads of 64, which the tiny test model does not have);
# QUICKTEST_DEVICE=cpu runs the tiny model on the CPU. OUT defaults to
# saves/quicktest_torch (git-ignored).
set -e
cd "$(dirname "$0")/../.."

OUT=${1:-saves/quicktest_torch}
DEVICE=${QUICKTEST_DEVICE:-cuda}
MODEL=$([ "$DEVICE" = cpu ] && echo tiny || echo data2vec-base)
rm -rf "$OUT"
mkdir -p "$OUT"

python scripts/make_synthetic_data.py --out "$OUT/data" --speakers 6 --utts_per_speaker 3

COMMON=(--model_type "$MODEL" --audio_dir "$OUT/data/clips"
        --train_csv "$OUT/data/train.csv" --test_csv "$OUT/data/test.csv"
        --spk2label "$OUT/data/spk2label.npy" --dataset_cache "$OUT/cache"
        --compute_dtype float32 --train_batch_size 4 --eval_batch_size 4
        --device "$DEVICE")
CLI=(python -m privacy_preserve_federated_asr_tpu_torch.cli)

"${CLI[@]}" train --epochs 2 -st 0 -model_out "$OUT/model" -log quicktest.txt "${COMMON[@]}"

"${CLI[@]}" extract -st 2 -model_in "$OUT/model/final" -csv quicktest \
  --csv_out_dir "$OUT/results" "${COMMON[@]}"

"${CLI[@]}" svm --train_pkl "$OUT/results/quicktest_train.pkl" \
  --test_pkl "$OUT/results/quicktest.pkl" \
  --spk2label "$OUT/data/spk2label.npy" -sq mean \
  --results_csv "$OUT/results/SVM/results.csv" --device "$DEVICE"

"${CLI[@]}" detail-wer --pkl "$OUT/results/quicktest.pkl" -t 2 --out_dir "$OUT/wer"

"${CLI[@]}" feat-scoring --pkl "$OUT/results/quicktest.pkl" --out_dir "$OUT/fsm_info"

echo "quicktest OK: artifacts under $OUT"
