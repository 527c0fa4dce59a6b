"""Asynchronous successive halving (ASHA) on the port's shared-state service
(the twin of ``examples/async_hyperband.py``).

The workload the paper's *synchronous* future constructs cannot express
alone: hyperparameter search where workers publish partial results **as
they finish each rung** and the driver prunes losers **mid-flight** —
nobody waits for a generation barrier. The shared-state service
(``repro_torch.core.state``) is the missing channel:

* each trial is one ordinary ``future()`` — on ``plan("threads")`` here:
  the original plans a launched cluster (``spec("cluster", hosts=2)``),
  which waits for the port's out-of-process backends;
* the trial body publishes its loss at rung ``r`` with
  ``state.put(f"rung/{r}/{cid}", loss)`` and polls its own kill switch
  ``state.get(f"stop/{cid}")`` at every rung boundary;
* the driver never blocks on any single trial: it watches the rung
  boards with ``state.keys(prefix)``, ranks whatever has been reported
  *so far*, and flips the stop keys of trials outside the top ``1/eta``
  — the asynchronous-halving rule.

Every arrow in that picture is a versioned KV op on the driver-hosted
:class:`~repro_torch.core.state.StateService`; the trials see it
through the same ``state.*`` calls on every backend.

Walkthrough of one run (eta=2, 4 rungs, 8 trials): all 8 report at rung
0; the driver keeps the best 4 and flips ``stop/<cid>`` for the rest,
*while those trials are still training* — they notice at their next rung
boundary and return early with status ``"pruned"``. The survivors repeat
at rung 1 (keep 2) and rung 2 (keep 1), so roughly ``N * (1 + 1/2 + 1/4
+ ...)`` epochs of work are spent instead of ``N * RUNGS`` — and because
pruning is asynchronous, a straggler cannot hold back a winner.

Each trial's simulated loss is computed on the device.

Run on the GPU:  PYTHONPATH=src python examples/async_hyperband_torch.py
On the CPU:      PYTHONPATH=src python examples/async_hyperband_torch.py --device cpu
"""

import argparse
import math
import time

import torch

import repro_torch.core as rc
from repro_torch.core import future, gather, plan, state, value
from repro_torch.device import resolve_device

ETA = 2          # keep the top 1/ETA at every rung
RUNGS = 4
N_TRIALS = 8


def make_trial_body(rungs: int, device):
    """Build the trial body as a *local* function (so it would ship to
    out-of-process workers by value, as in the original)."""
    def train_trial(cid: int, lr: float, _rungs=rungs, _device=device):
        """One trial: simulated training reporting per-rung validation
        loss to the shared-state board, honouring its stop key. The loss
        model rewards lr near 0.1 with diminishing returns per rung —
        deterministic, so the demo's winner is reproducible."""
        import time as _time
        from repro_torch.core import state
        loss = None
        for r in range(_rungs):
            if state.get(f"stop/{cid}", False):
                return {"cid": cid, "status": "pruned",
                        "rung": r, "loss": loss}
            # later rungs cost more (like real epochs over growing budgets)
            # and per-trial jitter keeps the reports asynchronous
            _time.sleep(0.04 * (r + 1) * (1 + (cid * 7) % 3) / 2)
            loss = float((torch.tensor(lr, dtype=torch.float64,
                                       device=_device) - 0.1) ** 2
                         + 0.5 / (r + 1))
            state.put(f"rung/{r}/{cid}", loss)
        return {"cid": cid, "status": "done", "rung": _rungs, "loss": loss}
    return train_trial


def asha_prune_pass():
    """One driver-side pruning sweep: for every rung, rank the trials
    that have reported *so far* and flip the stop key of any trial
    outside the top ceil(n / ETA). Asynchronous: acts on partial boards,
    never waits for a full generation."""
    stopped = []
    for r in range(RUNGS - 1):                   # last rung never prunes
        board = []
        for key in state.keys(f"rung/{r}/"):
            cid = int(key.rsplit("/", 1)[1])
            board.append((state.get(key), cid))
        if len(board) < ETA:
            continue                             # too early to judge
        board.sort()
        keep = math.ceil(len(board) / ETA)
        for _loss, cid in board[keep:]:
            if not state.get(f"stop/{cid}", False):
                state.put(f"stop/{cid}", True)
                stopped.append((r, cid))
    return stopped


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args().device)
    plan("threads", workers=N_TRIALS)             # one worker a trial
    lrs = [0.1 * (1.6 ** (i - 3)) for i in range(N_TRIALS)]
    body = make_trial_body(RUNGS, device)
    trials = [future(lambda c=i, lr=lr, b=body: b(c, lr))
              for i, lr in enumerate(lrs)]

    # the driver's ASHA loop: poll the rung boards while trials fly
    done = gather(trials)
    while not rc.resolved(done):
        for rung, cid in asha_prune_pass():
            print(f"  rung {rung}: pruned trial {cid} "
                  f"(lr={lrs[cid]:.4f}) mid-flight")
        time.sleep(0.02)

    results = value(done)
    survivors = [t for t in results if t["status"] == "done"]
    best = min(survivors, key=lambda t: t["loss"])
    print("\ntrial outcomes:")
    for t in sorted(results, key=lambda t: t["cid"]):
        print(f"  trial {t['cid']}: lr={lrs[t['cid']]:.4f} "
              f"{t['status']:6s} at rung {t['rung']} loss={t['loss']}")
    epochs = sum(t["rung"] for t in results)
    print(f"\nbest: trial {best['cid']} (lr={lrs[best['cid']]:.4f}, "
          f"loss={best['loss']:.4f})")
    print(f"epochs spent: {epochs} of {N_TRIALS * RUNGS} synchronous")
    assert len(survivors) < N_TRIALS, "pruning never fired"
    rc.shutdown()


if __name__ == "__main__":
    main()
