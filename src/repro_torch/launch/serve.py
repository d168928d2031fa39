"""Batched serving driver: prefill a batch of prompts, then decode tokens
step by step against the cache (KV or SSM state); counterpart of
``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --batch 4 --prompt-len 4096 --gen 32                         # the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b \\
      --device cpu

``--arch`` takes every architecture of ``repro_torch.configs.ARCH_IDS``,
mamba2-130m by default, as the reference's: the dense nemotron-4-15b,
starcoder2-3b, gemma-7b and command-r-plus-104b, the Mamba2 SSD
mamba2-130m, the hybrid hymba-1.5b (attention and SSD heads side by side;
the SSD prefill runs the ssd_intra_chunk kernel), the MLA + MoE
deepseek-v2-lite-16b and deepseek-v3-671b, the multimodal backbone
llava-next-34b (served on text prompts, as the reference serves it: its
patch embeddings go through ``transformer.prefill(patch_emb=)``) and the
audio musicgen-medium, whose prompts and sampled tokens carry its K
codebooks, (B, S, K).  ``--full`` draws the registered config at full
width: command-r-plus-104b (208 GB in bf16) and deepseek-v3-671b (1.34 TB)
do not fit one card that way.

Runs on the CUDA device unless ``--device cpu`` is given.  Weights are
random, drawn from ``--seed``; so are the prompts and the sampled tokens
(a seeded ``torch.Generator``, whose draws differ from ``jax.random``'s).
The work is in :func:`serve`, which takes a config, so a caller can serve
a variant (``attn_impl="flash"``) of a registered one.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.params import init_params, param_count


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample(logits: torch.Tensor, temperature: float,
           gen: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of logits: (B, 1, V) -> (B, 1) ids, or
    (B, 1, K, V) -> (B, 1, K), one draw per codebook."""
    probs = torch.softmax(logits[:, 0] / temperature, dim=-1)
    # torch.multinomial takes at most 2-D input
    ids = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                            generator=gen)
    return ids.reshape(logits.shape[0], 1, *logits.shape[2:-1])


def serve(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 64,
          gen: int = 32, temperature: float = 1.0, seed: int = 0,
          device=None, params=None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens one step at a time, sampling each from the
    previous step's logits.  ``params`` defaults to ``init_params(cfg,
    seed=seed)``.  Prompts and ids carry the codebooks of an audio config,
    (B, S, K) and (B, gen, K).  Returns the prompts, the prefill's
    last-position logits, the sampled ids (B, gen[, K]), the last step's
    logits, the cache, and the
    prefill's and the decode loop's wall seconds (the card synchronised at
    both ends of each)."""
    device = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    rng = torch.Generator(device=device).manual_seed(seed)
    B, S = batch, prompt_len
    K = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompts = torch.randint(0, cfg.vocab, (B, S, *K), generator=rng,
                            device=device)

    _sync(device)
    t0 = time.perf_counter()
    cache = transformer.init_cache(cfg, B, S + gen, device)
    prefill_logits, cache = transformer.prefill(params, cfg, prompts, cache)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    tokens = []
    logits = prefill_logits
    t0 = time.perf_counter()
    for i in range(gen):
        nxt = sample(logits, temperature, rng)
        tokens.append(nxt)
        logits, cache = transformer.decode_step(params, cfg, cache, nxt,
                                                S + i)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return dict(prompts=prompts, prefill_logits=prefill_logits,
                tokens=torch.cat(tokens, dim=1) if tokens else prompts[:, :0],
                logits=logits, cache=cache, prefill_s=prefill_s,
                decode_s=decode_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m", choices=ARCH_IDS,
                    help="an architecture: " + ", ".join(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; the CUDA device otherwise")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    B, S = args.batch, args.prompt_len
    params = init_params(cfg, seed=args.seed, device=device)
    print(f"serving {cfg.name}: params={param_count(params):,} "
          f"batch={B} prompt={S} gen={args.gen} on {device}")
    out = serve(cfg, batch=B, prompt_len=S, gen=args.gen,
                temperature=args.temperature, seed=args.seed, device=device,
                params=params)
    print(f"prefill {B}x{S}: {out['prefill_s']:.2f}s "
          f"({B * S / out['prefill_s']:.1f} tok/s)")
    toks, dt = B * args.gen, out["decode_s"]
    if args.gen:
        print(f"decode: {toks} tokens in {dt:.2f}s "
              f"({toks / dt:.1f} tok/s, {dt / args.gen * 1e3:.1f} ms/step)")
        print("sample token ids (seq 0):",
              out["tokens"][0].reshape(args.gen, -1)[:16, 0].tolist())
    if device.type == "cuda":
        print(f"device memory high-water mark: "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
