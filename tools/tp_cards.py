"""Tensor parallelism over NVLink: command-r-plus-104b at full width with
``--layers`` of its 64 layers, bf16, ``attn_impl="flash"``, its model axis
over N cards, one NCCL rank a card (``repro_torch.launch.cluster``).

    python3 tools/tp_cards.py --launch 4 --layers 4 16    # on a 4-card host

``--launch N`` starts N ranks of this script through ``python -m
repro_torch.launch.cluster`` (a ``file://`` init under ``build/``), waits
for them (killing all at ``--timeout``), prints their logs and exits
nonzero if any rank failed.  Each rank, for each depth: draws the full
tree from seed 0 on its card and keeps its shards
(``models.params.shard_params``), then under the grid serves 4 prompts of
4,096 tokens and ``chip_smoke.ZOO_GEN`` decode steps (flash_attention
once per layer per prefill on the rank's heads, none per decode step),
times a warm prefill (after an untimed one, which lines the ranks up)
and ``chip_smoke.WARM_STEPS`` decode steps and the
NCCL all-reduces' share of each (``models.sharding.time_collectives``),
and holds the sharded flash logits against the sharded model with
attention in f32 within ``chip_smoke.LOGITS_FACTOR`` of the chunked
path's error; at 4 layers rank 0 also holds them against the unsharded
flash logits of the same weights on its own card (reported).  One JSON
line per rank and depth; the card's name and power limit beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as c  # noqa: E402

c.import_port()
import torch  # noqa: E402


def rank_run(layers: int, dev, grid) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, shard_params
    from repro_torch.models.sharding import (collective_stats,
                                             time_collectives, use_mesh)
    cfg = c.zoo_config(c.TP_ARCH, "flash", layers)
    B, S, rank = c.SERVE_BATCH, c.PROMPT_LEN, grid.coord("model")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    full = init_params(cfg, seed=0, device=dev)
    params = shard_params(full, cfg, grid)
    # rank 0 keeps the full tree at 4 layers, for the unsharded logits
    reference = full if layers == 4 and rank == 0 else None
    del full
    torch.cuda.empty_cache()
    with use_mesh(grid):
        ops.reset_launches()
        out = serve(cfg, batch=B, prompt_len=S, gen=c.ZOO_GEN, seed=0,
                    device=dev, params=params)
        torch.cuda.synchronize()
        served_launches = {k: n for k, n in ops.launches.items() if n}
    prompts, cache = out["prompts"], out["cache"]
    tok, served = out["tokens"][:, :1], out["prefill_logits"]
    finite = all(bool(torch.isfinite(out[k]).all())
                 for k in ("prefill_logits", "logits"))
    del out
    unsharded = None
    if reference is not None:       # outside the grid: the unsharded model
        unsharded = c.zoo_logits(reference, cfg, prompts)
        del reference
        torch.cuda.empty_cache()
    with use_mesh(grid):
        # one untimed prefill first: at 4 layers rank 0 has just run the
        # unsharded model, and the other ranks would wait for it at the
        # first all-reduce of the timed one
        transformer.prefill(params, cfg, prompts, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        transformer.prefill(params, cfg, prompts, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(c.WARM_STEPS):
            transformer.decode_step(params, cfg, cache, tok, S + i)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / c.WARM_STEPS
        # again, each all-reduce between two synchronisations
        time_collectives(True)
        collective_stats(reset=True)
        t0 = time.perf_counter()
        transformer.prefill(params, cfg, prompts, cache)
        torch.cuda.synchronize()
        timed_prefill_s = time.perf_counter() - t0
        pre = collective_stats(reset=True)
        t0 = time.perf_counter()
        for i in range(c.WARM_STEPS):
            transformer.decode_step(params, cfg, cache, tok, S + i)
        torch.cuda.synchronize()
        timed_step_s = (time.perf_counter() - t0) / c.WARM_STEPS
        dec = collective_stats(reset=True)
        time_collectives(False)
        del cache
        torch.cuda.empty_cache()
        chunked_cfg = dataclasses.replace(cfg, attn_impl="chunked")
        chunked = c.zoo_logits(params, chunked_cfg, prompts)
        ref = c.zoo_logits(params, chunked_cfg, prompts,
                           attend=c.attention_in_f32())
    e_got, e_plain = c.logit_errors(served, ref), c.logit_errors(chunked,
                                                                 ref)
    within = all(g <= c.LOGITS_FACTOR * p for g, p in zip(e_got, e_plain))
    row = dict(rank=rank, layers=layers, model_ranks=grid.shape["model"],
               launches_per_prefill_and_steps=served_launches,
               finite=finite, warm_prefill_s=prefill_s,
               prefill_tokens_per_s=B * S / prefill_s,
               decode_ms_per_step=step_s * 1e3,
               timed_prefill_s=timed_prefill_s,
               prefill_all_reduce_share=pre["seconds"] / timed_prefill_s,
               prefill_all_reduces=pre["all_reduce"],
               prefill_all_reduce_mib=pre["bytes"] / 2 ** 20,
               timed_decode_ms_per_step=timed_step_s * 1e3,
               decode_all_reduce_share=dec["seconds"]
               / (timed_step_s * c.WARM_STEPS),
               flash_vs_f32=e_got, chunked_vs_f32=e_plain,
               within_factor=within,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               card=c.card_line())
    if unsharded is not None:
        row["flash_vs_unsharded_flash"] = c.logit_errors(served, unsharded)
    del params
    torch.cuda.empty_cache()
    if not (finite and within) or served_launches != {
            "flash_attention": layers}:
        raise RuntimeError(f"rank {rank}, {layers} layers: {row}")
    return row


def rank_main(depths) -> None:
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_smoke_mesh
    import torch.distributed as dist
    build.build()
    dev = torch.device("cuda", torch.cuda.current_device())
    grid = make_smoke_mesh(1, dist.get_world_size())
    for layers in depths:
        print(json.dumps({"tp_cards": rank_run(layers, dev, grid)}),
              flush=True)


def launch(n: int, depths, timeout: float) -> int:
    out = ROOT / "build" / "tp_cards"
    out.mkdir(parents=True, exist_ok=True)
    init = out / "pg"
    if init.exists():
        init.unlink()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs, logs = [], []
    for r in range(n):
        logs.append(open(out / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.cluster",
             "--coordinator", f"file://{init}", "--num-processes", str(n),
             "--process-id", str(r), "--", "python", str(Path(__file__)),
             "--layers", *map(str, depths)],
            cwd=ROOT, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r in range(n):
        for line in (out / f"rank{r}.log").read_text().splitlines():
            print(f"[rank {r}] {line}")
    codes = [p.returncode for p in procs]
    print(json.dumps({"exit_codes": codes}))
    return int(any(codes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launch", type=int, default=0,
                    help="start this many ranks, one a card")
    ap.add_argument("--layers", type=int, nargs="+", default=[4])
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/tp_cards.py needs CUDA cards")
    if args.launch:
        return launch(args.launch, args.layers, args.timeout)
    rank_main(args.layers)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
