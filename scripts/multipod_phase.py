#!/usr/bin/env python3
"""Phase 6e of ``chip_smoke.py`` alone, after its phase 1 (the build): the
multi-pod DiLoCo driver with two xLSTM-125M pods at full width as cluster
workers on one NVIDIA GPU, every check and print of the phase.

    python3 scripts/multipod_phase.py

The parameters are drawn from ``chip_smoke.SEED`` on the card, as phase 3
draws them. Prints the card's name and power limit and each phase's
seconds; exits non-zero if a check fails or there is no card.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("multipod_phase: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import Model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    _build.build_all()
    cs.phase_done("1")
    cfg = get_arch("xlstm-125m")
    params = Model(cfg).init(torch.Generator().manual_seed(cs.SEED),
                             device="cuda")
    cs.phase_done("params")
    cs.multipod_phase(cfg, params, smi)
    cs.phase_done("6e")
    return 0


if __name__ == "__main__":
    sys.exit(main())
