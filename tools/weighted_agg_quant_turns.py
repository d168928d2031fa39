#!/usr/bin/env python3
"""Time the weighted_agg_quant kernel in turns against another checkout's
version of its source, on one CUDA card.

    python3 tools/weighted_agg_quant_turns.py --against DIR

Run it from the root of a checkout.  DIR is the root of another checkout
(an unpacked ``git archive`` of an earlier commit, say): its
``src/repro_torch/kernels/csrc/weighted_agg_quant.cu`` is built beside this
tree's (one nvcc each, started together; their ptxas lines are printed),
both are held equal to the plain version, and at each shape of SHAPES the
two are timed in turns, forward and then backward (A, B, B, A), by CUDA
events around 100 back-to-back launches: from device memory, the input sets
rotated out of the 50 MB L2 as in ``chip_smoke.rotation``, and from L2, one
set launched again and again.  The last line is one JSON object: the card,
and per shape and version the two turns' times in ms beside the byte
bound.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (after the path is set)

SOURCE = "src/repro_torch/kernels/csrc/weighted_agg_quant.cu"
# (K, chunk) at the EMNIST CNN's D: the int8 wire's shape and one of four
# ranks' 16-row slab
SHAPES = [(cs.N_CLIENTS, cs.QUANT_CHUNK), (16, cs.QUANT_CHUNK)]
D = 461_630


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: torch.cuda.is_available() is "
                         "False")
    from repro_torch.kernels import build
    from repro_torch.kernels import weighted_agg as agg

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    cs.log(f"card: {card}")
    out = build.BUILD_DIR / "turns"
    out.mkdir(parents=True, exist_ok=True)
    # each source's quoted includes resolve beside it first, so the other
    # checkout's source takes its own headers
    jobs = {}
    for name, root in (("this", ROOT), ("against", args.against)):
        target = out / f"lib{name}.so"
        jobs[name] = (target, build.compile_source(root / SOURCE, target))
    signature = {"weighted_agg_quant":
                 agg.QUANT_SIGNATURES["weighted_agg_quant"]}
    libs = {}
    for name, (target, proc) in jobs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{report}")
        for line in cs.ptxas_summary(report):
            cs.log(f"  {name}: {line}")
        libs[name] = build.open_library(target, signature)

    gen = torch.Generator(device=dev).manual_seed(21)
    result = {"card": card, "shapes": {}}
    for K, chunk in SHAPES:
        sets = cs.rotation(lambda: cs.quantized(dev, gen, K, D, chunk, 127),
                           K * D)
        c, payload, scales = next(sets)
        Dp, n_chunks = payload.shape[1], scales.shape[1]
        want = agg.weighted_agg_quant_plain(c, payload, scales, chunk)
        for name, lib in libs.items():
            got = agg.launch_quant(c, payload, scales, chunk, lib=lib)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} differs from the plain version "
                                   f"at K={K}")
        bound, _ = cs.bound_ms(K * Dp + 4 * (K * n_chunks + K + Dp),
                               3 * K * Dp)
        rows = {}
        for turn in (list(libs), list(libs)[::-1]):
            for name in turn:
                lib = libs[name]
                hbm = cs.device_ms(lambda: agg.launch_quant(
                    *next(sets), chunk, lib=lib), 100)
                l2 = cs.device_ms(lambda: agg.launch_quant(
                    c, payload, scales, chunk, lib=lib), 100)
                r = rows.setdefault(name, dict(hbm_ms=[], l2_ms=[]))
                r["hbm_ms"].append(hbm)
                r["l2_ms"].append(l2)
        cs.log(f"({K}, {Dp}) int8, chunk {chunk}: bound {bound * 1e3:.2f} us")
        for name, r in rows.items():
            hbm, l2 = (", ".join(f"{t * 1e3:.2f}" for t in r[key])
                       for key in ("hbm_ms", "l2_ms"))
            cs.log(f"  {name:8s} from device memory {hbm} us, from L2 {l2} "
                   f"us")
        result["shapes"][f"{K}x{Dp}"] = dict(bound_ms=bound, versions=rows)
        del sets, c, payload, scales, want
    cs.log(json.dumps(result))


if __name__ == "__main__":
    main()
