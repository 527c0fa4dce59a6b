#!/usr/bin/env python3
"""Where the time of shipping xLSTM-125M's parameters to a ``processes``
worker goes, step by step, on one NVIDIA GPU and its host.

    python3 scripts/ship_costs.py [--arch xlstm-125m]

The parameters (random from seed 0, on the card) are a dict global of a
future, so the backend pickles the dict at every ``future()``, digests the
pickle, and for a worker that lacks it encodes it (zlib level 1 over the
pickle) and the worker decodes it again at every task: a dict is not kept
decoded. Times each of those steps once, on the host's clock with the card
synchronised:
  pickle: ``dumps_robust`` of the dict (each tensor copied to the host);
  digest: blake2b of the pickle;
  encode: ``encode_payload`` of the dict from that pickle (the zlib pass);
  decode: ``decode_payload`` of the blob, back to tensors on the card.
Beside them, the same bytes as one payload a tensor leaf, as a top-level
tensor global ships: each leaf's digest, raw encode and decode.
Prints the card's name and power limit; the last line is a JSON object
with every number.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ship_costs: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.core.backends import blobstore, transport
    from repro_torch.core.globals_capture import dumps_robust
    from repro_torch.models import Model
    from repro_torch.tree import leaves

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    params = Model(get_arch(args.arch)).init(
        torch.Generator().manual_seed(0), device=dev)
    tensors = list(leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    out = {"arch": args.arch, "card": smi, "param_bytes": nbytes,
           "leaves": len(tensors)}
    pickled, out["pickle_ms"] = timed(lambda: dumps_robust(params))
    _, out["digest_ms"] = timed(lambda: blobstore.blob_digest(pickled))
    blob, out["encode_ms"] = timed(lambda: transport.encode_payload(
        params, pickled=pickled))
    back, out["decode_ms"] = timed(lambda: transport.decode_payload(blob)[0])
    out["pickle_bytes"], out["blob_bytes"] = len(pickled), len(blob)
    out["codec"] = {transport.P_ZPICKLE: "zlib pickle",
                    transport.P_PICKLE: "pickle"}[blob[0]]
    same = all(torch.equal(a, b) for a, b in zip(leaves(back), tensors))
    del back, blob, pickled

    def per_leaf_digests():
        blobstore._MEMO.clear()
        return [blobstore.content_digest(t) for t in tensors]

    _, out["leaf_digest_ms"] = timed(per_leaf_digests)
    _, out["leaf_digest_memo_ms"] = timed(
        lambda: [blobstore.content_digest(t) for t in tensors])
    blobs, out["leaf_encode_ms"] = timed(
        lambda: [transport.encode_payload(t) for t in tensors])
    back, out["leaf_decode_ms"] = timed(
        lambda: [transport.decode_payload(b)[0] for b in blobs])
    out["leaf_blob_bytes"] = sum(len(b) for b in blobs)
    same = same and all(torch.equal(a, b) for a, b in zip(back, tensors))
    out["round_trip_equal"] = same
    print(f"{args.arch}: {nbytes / 1e6:.1f} MB in {len(tensors)} tensors "
          f"({smi})")
    print(f"  the dict: pickle {out['pickle_ms']:.1f} ms "
          f"({out['pickle_bytes']} B), digest {out['digest_ms']:.1f} ms, "
          f"encode {out['encode_ms']:.1f} ms ({out['codec']}, "
          f"{out['blob_bytes']} B), decode to the card "
          f"{out['decode_ms']:.1f} ms")
    print(f"  a payload a leaf: digests {out['leaf_digest_ms']:.1f} ms "
          f"({out['leaf_digest_memo_ms']:.3f} ms memoized), raw encode "
          f"{out['leaf_encode_ms']:.1f} ms ({out['leaf_blob_bytes']} B), "
          f"decode to the card {out['leaf_decode_ms']:.1f} ms; round trips "
          f"bit for bit: {same}")
    print(json.dumps(out))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
