#!/usr/bin/env bash
# Start P local processes of the PyTorch port, wired together through the
# env contract of repro_torch.launch.distributed exactly as P hosts would
# be (REPRO_COORDINATOR_ADDRESS, REPRO_NUM_PROCESSES, REPRO_PROCESS_ID):
# one torch.distributed rank per process, rank 0 serving the TCP store.
#
#     scripts/launch_multiprocess_torch.sh [-p procs] [-P coordinator-port] \
#         [-- cmd args...]
#
# The default command is the bring-up smoke on the card (gloo; each
# process prints SMOKE_OK proc=i/P ..., and an all_reduce over every
# process checks the group); pass your own after --, e.g. on the CPU
#
#     scripts/launch_multiprocess_torch.sh -p 2 -- \
#         python -m repro_torch.launch.distributed --smoke \
#         --global-collective --device cpu
#
# Exits 1 if any process fails.
set -euo pipefail
cd "$(dirname "$0")/.."

PROCS=2
PORT="${REPRO_COORDINATOR_PORT:-$(( (RANDOM % 2000) + 29000 ))}"

while getopts "p:P:h" opt; do
  case "$opt" in
    p) PROCS="$OPTARG" ;;
    P) PORT="$OPTARG" ;;
    h) grep '^#' "$0" | sed 's/^# \{0,1\}//'; exit 0 ;;
    *) exit 2 ;;
  esac
done
shift $((OPTIND - 1))

if [ "$#" -gt 0 ]; then
  CMD=("$@")
else
  CMD=(python -m repro_torch.launch.distributed --smoke
       --expect-processes "$PROCS" --global-collective)
fi

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export REPRO_COORDINATOR_ADDRESS="127.0.0.1:${PORT}"
export REPRO_NUM_PROCESSES="$PROCS"

PIDS=()
for ((i = 0; i < PROCS; i++)); do
  REPRO_PROCESS_ID="$i" "${CMD[@]}" &
  PIDS+=($!)
done

FAIL=0
for pid in "${PIDS[@]}"; do
  wait "$pid" || FAIL=1
done
if [ "$FAIL" -ne 0 ]; then
  echo "launch_multiprocess_torch: at least one process failed" >&2
  exit 1
fi
echo "launch_multiprocess_torch: ${PROCS} processes OK"
