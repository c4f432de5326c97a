#!/usr/bin/env bash
# End-to-end training launch of the port (data prep -> TTS -> vocoder),
# resumable; the counterpart of scripts/run_training.sh through
# `python -m rtts_torch.cli`, on the card unless `--device cpu` is given.
#
#   rtts_torch/scripts/run_training.sh [CONFIG] [WORKDIR] [CLI OPTION ...]
#
# CLI OPTIONs go before each verb (`-o key.path=value`, `--device cpu`).
# RTTS_SKIP_VOCODER=1 stops after the TTS model.
set -euo pipefail

CONFIG=${1:-configs/base.yaml}
WORKDIR=${2:-runs}
shift $(( $# < 2 ? $# : 2 ))
CLI=(python -m rtts_torch.cli -c "$CONFIG" "$@")

# data: pull from the artifact remote if configured, else synthesize corpus
if [ -n "${RTTS_DATA_REMOTE:-}" ] && [ -f data.lock.json ]; then
  python -c "from rtts_torch.data.versioning import pull; import os; \
    print(pull('data.lock.json', os.environ['RTTS_DATA_REMOTE']))"
else
  "${CLI[@]}" generate-corpus
fi

"${CLI[@]}" preprocess
"${CLI[@]}" train-tts --workdir "$WORKDIR/tts"
if [ "${RTTS_SKIP_VOCODER:-0}" = "0" ]; then
  "${CLI[@]}" train-vocoder --workdir "$WORKDIR/vocoder"
fi
