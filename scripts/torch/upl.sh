#!/bin/bash
# UPL (Unsupervised Prompt Learning) integration point.
#
# The reference's upl.sh shells into an EXTERNAL, not-checked-in UPL
# repository (reference README); there is nothing in-repo to rebuild. If you
# have a UPL checkout, point UPL_ROOT at it and this script forwards the
# feature-store artifacts produced by scripts/torch/save_features.sh (the same
# (N, emb_dim) .npy layout as the JAX package's store; transpose for torch
# consumers).
set -euo pipefail
if [ -z "${UPL_ROOT:-}" ]; then
    echo "upl.sh: set UPL_ROOT to an external UPL checkout (not part of this repo)." >&2
    exit 2
fi
cd "${UPL_ROOT}"
exec bash upl.sh "$@"
