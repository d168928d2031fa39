"""The CUDA kernels against their plain versions on the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  On the card,
where the reference package's jax is not installed, this file runs alone:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.masked_sgd import masked_sgd_plain
from repro_torch.kernels.weighted_agg import padded, weighted_agg_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import resolve_device
    return resolve_device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,D", [(62, 461630), (62, 461631), (62, 461632),
                                 (100, 4099), (1, 3)])
def test_weighted_agg_kernel_matches_plain(card, K, D, dtype):
    gen = torch.Generator(device=card).manual_seed(K + D)
    c = torch.rand(K, device=card, generator=gen)
    d = padded(torch.randn(K, D, device=card, generator=gen).to(dtype))
    before = ops.launches["weighted_agg"]
    got = ops.weighted_agg(c, d)
    torch.cuda.synchronize()
    assert ops.launches["weighted_agg"] == before + 1
    torch.testing.assert_close(got, weighted_agg_plain(c, d),
                               **ops.TOLERANCE["weighted_agg"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(62, 401408), (62, 62), (62, 800),
                                   (16384,), (7,)])
def test_masked_sgd_kernel_matches_plain(card, shape, dtype):
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    w = torch.randn(*shape, device=card, generator=gen).to(dtype)
    g = torch.randn(*shape, device=card, generator=gen).to(dtype)
    s = torch.rand(shape[0] if len(shape) == 2 else 1, device=card,
                   generator=gen)
    before = ops.launches["masked_sgd"]
    got = ops.masked_sgd(w.clone(), g, s)
    torch.cuda.synchronize()
    assert ops.launches["masked_sgd"] == before + 1
    torch.testing.assert_close(got, masked_sgd_plain(w.clone(), g, s),
                               **ops.TOLERANCE["masked_sgd"][dtype])


def test_kernels_refuse_mixed_devices(card):
    with pytest.raises(ValueError):
        ops.weighted_agg(torch.ones(3), torch.ones(3, 5, device=card))


@pytest.mark.parametrize("shape", [(3, 5), (3, 6)])
def test_weighted_agg_kernel_refuses_rows_off_16_bytes(card, shape):
    # rows 5 or 6 f32 apart do not all start on a 16-byte vector
    with pytest.raises(ValueError, match="padded"):
        ops.weighted_agg(torch.ones(3, device=card),
                         torch.ones(*shape, device=card))
    with pytest.raises(ValueError):
        ops.masked_sgd(torch.ones(5, device=card), torch.ones(5, device=card),
                       torch.ones(()))


# (B, H, KV, S, hd); the bf16 kernel's tiles are 128 query rows by 128 keys
# (64 keys at hd 256): S = 1, 17 and 64 lie inside one tile, 129 and 257 one
# row past a tile, and (1, 8, 8, 300, 128) has KV = H; at hd 256 (gemma's)
# S = 65 is one key past a KV tile, 100 and 300 ragged
FLASH_SHAPES = [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 4, 1, 384, 128),
                (2, 2, 2, 100, 32), (1, 48, 8, 1000, 128),
                (1, 4, 2, 1, 128), (2, 4, 2, 17, 128), (1, 4, 2, 64, 64),
                (1, 4, 2, 129, 128), (1, 4, 2, 257, 128), (1, 8, 8, 300, 128),
                (1, 4, 2, 100, 256), (2, 2, 2, 65, 256), (1, 16, 16, 300, 256)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,hd", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(card, B, H, KV, S, hd, dtype,
                                              causal):
    from repro_torch.kernels.flash_attention import flash_attention_plain
    gen = torch.Generator(device=card).manual_seed(B * H * S + hd)
    q, k, v = (torch.randn(B, n, S, hd, device=card, generator=gen).to(dtype)
               for n in (H, KV, KV))
    before = ops.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, causal),
                               **ops.TOLERANCE["flash_attention"][dtype])


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 64),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128)])
def test_flash_attention_kernel_reads_strided_projections(card, dtype, hd):
    # the model's layout: (B, S, heads, hd) projections, transposed views
    from repro_torch.kernels.flash_attention import flash_attention_plain
    gen = torch.Generator(device=card).manual_seed(7)
    B, S, H, KV = 2, 200, 8, 2
    q = torch.randn(B, S, H, hd, device=card, generator=gen).to(dtype)
    k = torch.randn(B, S, KV, hd, device=card, generator=gen).to(dtype)
    v = torch.randn(B, S, KV, hd, device=card, generator=gen).to(dtype)
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2))
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2))
    torch.testing.assert_close(got, want,
                               **ops.TOLERANCE["flash_attention"][dtype])


def test_flash_attention_kernel_takes_more_than_65535_batch_heads(card):
    # the bf16 kernel's grid is 1-D over (query tile, b * h); the f32
    # kernel's has one row per (b, h) and refuses B * H above 65535
    from repro_torch.kernels.flash_attention import flash_attention_plain
    gen = torch.Generator(device=card).manual_seed(8)
    B, H, KV, S, hd = 2, 32800, 8200, 5, 32
    q, k, v = (torch.randn(B, n, S, hd, device=card, generator=gen)
               .to(torch.bfloat16) for n in (H, KV, KV))
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, flash_attention_plain(q, k, v),
        **ops.TOLERANCE["flash_attention"][torch.bfloat16])
    with pytest.raises(ValueError, match="65535"):
        ops.flash_attention(q.float(), k.float(), v.float())


def test_flash_attention_kernel_refuses_what_it_cannot_read(card):
    x = torch.ones(1, 2, 16, 96, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="96"):
        ops.flash_attention(x, x, x)
    y = torch.ones(1, 2, 16, 72, device=card, dtype=torch.bfloat16)[..., 4:68]
    with pytest.raises(ValueError, match="16 bytes"):
        ops.flash_attention(y, y, y)


def test_reduced_lm_prefill_on_the_card_matches_the_cpu(card):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config("nemotron-4-15b").reduced(),
                              attn_impl="flash")
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 100),
                           generator=torch.Generator().manual_seed(0))
    want, _ = transformer.prefill(
        params, cfg, tokens, transformer.init_cache(cfg, 2, 100, "cpu"))


    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(card)

    on_card = to_card(params)
    before = ops.launches["flash_attention"]
    got, _ = transformer.prefill(on_card, cfg, tokens.to(card),
                                 transformer.init_cache(cfg, 2, 100, card))
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# the LM zoo's reduced configs in f32 (gemma's also at its real head dim of
# 256 with attn_impl="flash"): a prefill past the reduced sliding window and
# two decode steps on the card against the CPU, and the kernels of the path
# launched once per layer per prefill; musicgen's prompts carry its
# codebooks, llava's prefill takes its 8 patches ahead of the text
ZOO_REDUCED = [("starcoder2-3b", {}), ("gemma-7b", {}),
               ("gemma-7b", {"head_dim": 256, "attn_impl": "flash"}),
               ("command-r-plus-104b", {"attn_impl": "flash"}),
               ("hymba-1.5b", {}), ("deepseek-v2-lite-16b", {}),
               ("deepseek-v3-671b", {}),
               ("llava-next-34b", {"attn_impl": "flash"}),
               ("musicgen-medium", {"attn_impl": "flash"})]


@pytest.mark.parametrize("arch,changes", ZOO_REDUCED)
def test_zoo_reduced_on_the_card_matches_the_cpu(card, arch, changes):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    params = init_params(cfg, seed=0, device="cpu")
    K = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    tokens = torch.randint(0, cfg.vocab, (2, 98, *K),
                           generator=torch.Generator().manual_seed(0))
    patches = 0.02 * torch.randn(2, cfg.n_patches, cfg.d_model,
                                 generator=torch.Generator().manual_seed(1))
    P = cfg.n_patches

    def run(p, toks, device):
        cache = transformer.init_cache(cfg, 2, P + 98, device)
        out = [transformer.prefill(
            p, cfg, toks[:, :96], cache,
            patch_emb=patches.to(device) if P else None)[0]]
        for t in (96, 97):
            out.append(transformer.decode_step(p, cfg, cache,
                                               toks[:, t:t + 1], P + t)[0])
        return out

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(card)

    want = run(params, tokens, "cpu")
    ops.reset_launches()
    got = run(to_card(params), tokens.to(card), card)
    torch.cuda.synchronize()
    flash = cfg.attn_impl == "flash" and not cfg.sliding_window
    assert ops.launches["flash_attention"] == (cfg.n_layers if flash else 0)
    assert ops.launches["ssd_intra_chunk"] == \
        (cfg.n_layers if cfg.family == "hybrid" else 0)
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b",
                                  "llava-next-34b"])
def test_lm_training_round_on_the_card_matches_the_cpu(card, arch):
    """One client-parallel LM round (launch/train.py's) on the card and on
    the CPU from the same params and batches: masked_sgd E x leaves
    launches and no forward-only kernel (the SSD term takes its
    differentiable form under grad), each leaf's delta within 1e-4 of its
    norm."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.fed_step import (flatten_tree, make_fed_round,
                                           per_client_loss)
    from repro_torch.launch.train import round_batches
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params

    cfg = get_config(arch).reduced()
    start = flatten_tree(init_params(cfg, seed=0, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in round_batches(
        np.random.default_rng(1), cfg, 0, n_clients=4, local_epochs=2,
        batch=2, seq=32).items()}
    alpha = torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 0.0], [1.0, 1.0]])
    coeffs = torch.tensor([0.25, 0.5, 0.0, 0.25])
    round_fn = make_fed_round(per_client_loss(
        lambda p, b: transformer.train_loss(p, cfg, b)), "client_parallel")

    def run(device):
        flat = {k: v.clone().to(device) for k, v in start.items()}
        round_fn(flat, {k: v.to(device) for k, v in batch.items()},
                 alpha.to(device), coeffs.to(device),
                 torch.tensor(0.05, device=device))
        return flat

    want = run("cpu")
    ops.reset_launches()
    got = run(card)
    torch.cuda.synchronize()
    assert {k: n for k, n in ops.launches.items() if n} == \
        {"masked_sgd": 2 * len(start)}
    for name, w in start.items():
        # elements an ulp apart at each of E = 2 local steps and the
        # aggregation are set aside where they are at most 1% of the leaf
        # (chip_smoke.TRAIN_FLIP_SHARE)
        diff = got[name].cpu() - want[name]
        top = torch.maximum(got[name].cpu().abs(), want[name].abs())
        flips = (diff != 0) & (diff.abs() <= 3 * (
            torch.nextafter(top, torch.tensor(float("inf"))) - top))
        if flips.float().mean() <= 0.01:
            diff = diff.masked_fill(flips, 0.0)
        assert diff.norm() <= 1e-4 * (want[name] - w).norm(), name


def _quantized(card, K, D, chunk, levels, seed):
    from repro_torch.core.compression import quantize_chunked
    gen = torch.Generator(device=card).manual_seed(seed)
    c = torch.rand(K, device=card, generator=gen)
    c[::7] = 0.0                              # clients with no work
    d = torch.randn(K, D, device=card, generator=gen)
    d[1::5] = 0.0                             # all-zero rows
    return (c,) + quantize_chunked(d, chunk=chunk, levels=levels)


# (K, D, chunk, levels, bytes added to the payload's row stride, the path
# the kernel takes to its scales: csrc/weighted_agg_quant.cu's header says
# which shapes take which)
@pytest.mark.parametrize("K,D,chunk,levels,wider,path", [
    (62, 461630, 256, 127, 0, "staged"), (1, 4099, 256, 127, 0, "staged"),
    (70, 4099, 256, 127, 0, "staged"), (62, 100000, 64, 127, 0, "staged"),
    (62, 461630, 100, 127, 0, "staged"), (8, 1000, 1, 127, 0, "per-code"),
    (62, 4099, 256, 7, 0, "staged"), (3, 16, 16, 127, 0, "staged"),
    (256, 65536, 256, 127, 0, "staged"), (257, 100000, 256, 127, 0, "staged"),
    (300, 461630, 256, 127, 0, "staged"), (4, 16, 4, 127, 0, "per-code"),
    (62, 10000, 256, 127, 0, "staged"), (62, 10000, 256, 127, 4096, "staged"),
    (5, 1001, 1, 127, 0, "per-code"), (8, 1000, 50, 127, 0, "per-code"),
    (62, 100000, 50, 127, 0, "per-code")])
def test_weighted_agg_quant_kernel_equals_plain(card, K, D, chunk, levels,
                                                wider, path):
    """The kernel makes the plain version's roundings in its order: equal,
    at the int8 wire's shape and at edge shapes (K > 64 in several row
    boxes, chunks 16 does not divide, one scale per code, rows padded to 16
    bytes or wider still, levels 7, D below one tile, fewer tiles than SMs,
    rows of scales that are not whole 16-byte vectors), each on the path
    named."""
    from repro_torch.kernels.weighted_agg import (quant_plan,
                                                  weighted_agg_quant_plain)
    c, payload, scales = _quantized(card, K, D, chunk, levels, K + D + chunk)
    if wider:
        rows = torch.zeros(K, payload.stride(0) + wider, dtype=torch.int8,
                           device=card)
        rows[:, :payload.shape[1]] = payload
        payload = rows[:, :payload.shape[1]]
    plan = quant_plan(payload, scales, chunk)
    assert plan["path"] == path
    assert plan["boxes"] == -(-K // plan["rows"])
    before = ops.launches["weighted_agg_quant"]
    got = ops.weighted_agg_quant(c, payload, scales, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launches["weighted_agg_quant"] == before + 1
    assert got.shape == (payload.shape[1],)
    assert torch.equal(got, weighted_agg_quant_plain(c, payload, scales,
                                                     chunk))


def test_weighted_agg_quant_kernel_allocates_only_its_output(card):
    K, D, chunk = 62, 461630, 256
    c, payload, scales = _quantized(card, K, D, chunk, 127, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    ops.weighted_agg_quant(c, payload, scales, chunk=chunk)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(card) - base
    assert rise <= 4 * payload.shape[1] + 2 ** 20


def test_weighted_agg_quant_kernel_refuses_unaligned_rows(card):
    payload = torch.zeros(3, 100, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="padded"):
        ops.weighted_agg_quant(torch.ones(3, device=card), payload,
                               torch.ones(3, 1, device=card), chunk=100)


def test_quantizer_on_the_card_equals_the_cpu(card):
    from repro_torch.core.compression import (compress_flat,
                                              resolve_compression)
    gen = torch.Generator(device=card).manual_seed(1)
    flat = torch.randn(62, 461630, device=card, generator=gen) * 1e-3
    for wire in ("int8", "int8-topk", "int8:chunk=100,levels=7"):
        spec = resolve_compression(wire)
        pc, sc = compress_flat(flat, spec)
        ph, sh = compress_flat(flat.cpu(), spec)
        assert torch.equal(pc.cpu(), ph)
        assert torch.equal(sc.cpu().view(torch.int32), sh.view(torch.int32))


def _ssd_inputs(card, G, Q, N, P, dtype, seed):
    """cum from mamba2's step sizes and decay rates (dt in [1e-3, 1e-1], A
    in [-16, -1]), so cum_i - cum_j above the diagonal overflows exp; C, B
    and xdt normal."""
    gen = torch.Generator(device=card).manual_seed(seed)
    dt = torch.exp(torch.empty(G, Q, device=card).uniform_(
        -6.907755, -2.302585, generator=gen))
    A = -torch.empty(G, 1, device=card).uniform_(1.0, 16.0, generator=gen)
    cum = torch.cumsum(dt * A, dim=-1)
    C, B = (torch.randn(G, Q, N, device=card, generator=gen).to(dtype)
            for _ in range(2))
    xdt = torch.randn(G, Q, P, device=card, generator=gen).to(dtype)
    return cum, C, B, xdt


def _f32_excess(got, cum, C, B, xdt):
    """max |got - y64| over the f32 rounding bound of any summation order
    (chip_smoke.SSD_F32_BOUND): 2^-24 sum_j (sum_n |C_in| |B_jn|) L_ij
    (N + Q + 8 + |cum_i - cum_j|) |xdt_j|, L the decay where j <= i."""
    Q, N = cum.shape[-1], C.shape[-1]
    cum = cum.double()
    d = cum[..., :, None] - cum[..., None, :]
    keep = torch.ones(Q, Q, dtype=torch.bool, device=cum.device).tril()
    L = torch.where(keep, torch.exp(torch.where(keep, d, 0.0)), 0.0)
    Cd, Bd, xd = C.double(), B.double(), xdt.double()
    y64 = (torch.einsum("...qn,...sn->...qs", Cd, Bd) * L) @ xd
    bound = 2.0 ** -24 * ((torch.einsum("...qn,...sn->...qs", Cd.abs(),
                                        Bd.abs())
                           * L * (N + Q + 8 + d.abs())) @ xd.abs())
    return ((got.double() - y64).abs() / bound.clamp_min(1e-300)).max() \
        .item()


SSD_SHAPES = [(96, 256, 128, 64), (6, 16, 8, 8), (6, 64, 32, 16),
              (6, 128, 64, 64), (12, 1, 128, 64), (12, 100, 128, 64),
              (12, 32, 16, 32), (5, 200, 40, 128), (3, 70, 7, 5),
              (4, 600, 256, 128), (3, 300, 12, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Q,N,P", SSD_SHAPES)
def test_ssd_intra_chunk_kernel_matches_plain(card, G, Q, N, P, dtype):
    from repro_torch.kernels.ssd_chunk import ssd_intra_chunk_plain
    cum, C, B, xdt = _ssd_inputs(card, G, Q, N, P, dtype, G + Q + N + P)
    before = ops.launches["ssd_intra_chunk"]
    got = ops.ssd_intra_chunk(cum, C, B, xdt)
    torch.cuda.synchronize()
    assert ops.launches["ssd_intra_chunk"] == before + 1
    assert got.shape == (G, Q, P) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ssd_intra_chunk_plain(cum, C, B, xdt),
                               **ops.TOLERANCE["ssd_intra_chunk"][dtype])
    if dtype == torch.float32:
        assert _f32_excess(got, cum, C, B, xdt) <= 1.0


def _ssd_split_cells(card, Go, H, Q, N, P, dtype, shared=("C", "B")):
    """The model's layout: (batch*chunks, heads) cells, C and B of one group
    expanded over its heads with stride 0 (those named in ``shared``; the
    others one per head), xdt a strided view of (batch*chunks, Q, heads,
    P)."""
    cum, C, B, _ = _ssd_inputs(card, Go * H, Q, N, P, dtype, 11 + H + Q)
    cum = cum.view(Go, H, Q)
    C, B = (t.view(Go, H, Q, N)[:, :1].expand(Go, H, Q, N) if name in shared
            else t.view(Go, H, Q, N) for t, name in ((C, "C"), (B, "B")))
    gen = torch.Generator(device=card).manual_seed(12)
    xdt = torch.randn(Go, Q, H, P, device=card, generator=gen).to(dtype) \
        .transpose(1, 2)
    return cum, C, B, xdt


# Q = 600 takes the f32 kernel's windows of four key tiles
@pytest.mark.parametrize("Q", [256, 100, 600])
@pytest.mark.parametrize("heads", [24, 5, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_chunk_kernel_reads_group_shared_rows(card, dtype, heads,
                                                        Q):
    """The model's layout, the output a view of (.., Q, heads, P); in f32
    the group's scores are computed once for the heads of a CTA."""
    from repro_torch.kernels.ssd_chunk import ssd_intra_chunk_plain
    Go, N, P = 6, 128, 64
    cum, C, B, xdt = _ssd_split_cells(card, Go, heads, Q, N, P, dtype)
    before = ops.launches["ssd_intra_chunk"]
    got = ops.ssd_intra_chunk(cum, C, B, xdt)
    torch.cuda.synchronize()
    assert ops.launches["ssd_intra_chunk"] == before + 1
    assert got.shape == (Go, heads, Q, P)
    assert got.transpose(1, 2).is_contiguous()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ssd_intra_chunk_plain(cum, C, B, xdt),
                               **ops.TOLERANCE["ssd_intra_chunk"][dtype])
    if dtype == torch.float32:
        assert _f32_excess(got, cum, C, B, xdt) <= 1.0


@pytest.mark.parametrize("shared", [("C",), ("B",)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_chunk_kernel_reads_c_or_b_shared_alone(card, dtype,
                                                          shared):
    """Only one of C and B through a stride-0 head dim: one head per CTA,
    each reading its own rows of the other."""
    from repro_torch.kernels.ssd_chunk import ssd_intra_chunk_plain
    cum, C, B, xdt = _ssd_split_cells(card, 6, 8, 256, 128, 64, dtype,
                                      shared)
    got = ops.ssd_intra_chunk(cum, C, B, xdt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ssd_intra_chunk_plain(cum, C, B, xdt),
                               **ops.TOLERANCE["ssd_intra_chunk"][dtype])


@pytest.mark.parametrize("heads", [1, 5, 24])
def test_ssd_intra_chunk_f32_kernel_takes_any_heads_per_cta(card, heads):
    """The f32 kernel at a set number of heads per CTA, blocks that do not
    divide the group's 24 heads included, against its plain version; the
    library's count of consumer warpgroups."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_chunk as sc
    lib = build.load("ssd_intra_chunk", sc.SIGNATURES)
    assert [lib.ssd_intra_chunk_f32_warpgroups(P) for P in (16, 64, 128)] \
        == [3, 3, 2]
    cum, C, B, xdt = _ssd_split_cells(card, 4, 24, 256, 128, 64,
                                      torch.float32)
    got = sc.launch(cum, C, B, xdt, heads=heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, sc.ssd_intra_chunk_plain(cum, C, B, xdt),
        **ops.TOLERANCE["ssd_intra_chunk"][torch.float32])


# hymba-1.5b's SSD: 50 heads of one group, N 16, P 64; (64, 256) is the
# serving prefill's cells, where one CTA takes all 50 heads; at (4, 64) and
# (16, 256) heads_per_cta cuts them into blocks of a multiple of the three
# consumer warpgroups, the last block ragged
@pytest.mark.parametrize("Go,Q", [(64, 256), (4, 64), (16, 256), (4, 256)])
def test_ssd_intra_chunk_kernel_at_hymbas_heads(card, Go, Q):
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_chunk as sc
    H, N, P = 50, 16, 64
    cum, C, B, xdt = _ssd_split_cells(card, Go, H, Q, N, P, torch.float32)
    lib = build.load("ssd_intra_chunk", sc.SIGNATURES)
    heads = sc.heads_per_cta(
        Go, H, Q, True,
        torch.cuda.get_device_properties(card).multi_processor_count,
        lib.ssd_intra_chunk_f32_warpgroups(P))
    assert heads == H or (heads % 3 == 0 and H % heads)
    got = ops.ssd_intra_chunk(cum, C, B, xdt)
    torch.cuda.synchronize()
    want = sc.ssd_intra_chunk_plain(cum, C, B, xdt)
    torch.testing.assert_close(
        got, want, **ops.TOLERANCE["ssd_intra_chunk"][torch.float32])
    assert _f32_excess(got, cum, C, B, xdt) <= 1.0


def test_ssd_intra_chunk_kernel_refuses_what_it_cannot_read(card):
    cum = torch.zeros(2, 16, device=card)
    x = torch.zeros(2, 16, 48, device=card)
    with pytest.raises(ValueError, match="P at most 16"):
        ops.ssd_intra_chunk(cum, x, x, x)
    y = torch.zeros(2, 16, 32, device=card)
    with pytest.raises(TypeError):
        ops.ssd_intra_chunk(cum, y, y, y.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_intra_chunk(cum, y[..., ::2], y[..., ::2], y)


@pytest.fixture
def nccl_rank(card, tmp_path):
    """A one-rank NCCL group for the sharded wrappers, destroyed after the
    test."""
    import torch.distributed as dist
    from repro_torch.fed import make_fed_sharding
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        yield make_fed_sharding()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,D", [(62, 461630), (16, 461630), (64, 600)])
def test_weighted_agg_sharded_at_one_nccl_rank(nccl_rank, card, K, D, dtype):
    """Against its plain version within ops.TOLERANCE (the reference's
    1e-4), and bit-identical to the unsharded kernel: one rank's
    all-reduce is the identity."""
    from repro_torch.kernels.weighted_agg import weighted_agg_sharded_plain
    gen = torch.Generator(device=card).manual_seed(K + D)
    c = torch.rand(K, device=card, generator=gen)
    d = padded(torch.randn(K, D, device=card, generator=gen).to(dtype))
    before = dict(ops.launches)
    got = ops.weighted_agg_sharded(c, d, sharding=nccl_rank)
    torch.cuda.synchronize()
    assert ops.launches == {**before, "weighted_agg_sharded":
                            before["weighted_agg_sharded"] + 1}
    torch.testing.assert_close(
        got, weighted_agg_sharded_plain(c, d, nccl_rank),
        **ops.TOLERANCE["weighted_agg_sharded"][dtype])
    assert torch.equal(got, ops.weighted_agg(c, d))


@pytest.mark.parametrize("K,D,chunk", [(62, 461630, 256), (16, 461630, 256),
                                       (64, 600, 100)])
def test_weighted_agg_quant_sharded_at_one_nccl_rank(nccl_rank, card, K, D,
                                                     chunk):
    from repro_torch.kernels.weighted_agg import \
        weighted_agg_quant_sharded_plain
    c, payload, scales = _quantized(card, K, D, chunk, 127, K + D)
    before = dict(ops.launches)
    got = ops.weighted_agg_quant_sharded(c, payload, scales, chunk=chunk,
                                         sharding=nccl_rank)
    torch.cuda.synchronize()
    assert ops.launches == {**before, "weighted_agg_quant_sharded":
                            before["weighted_agg_quant_sharded"] + 1}
    torch.testing.assert_close(
        got, weighted_agg_quant_sharded_plain(c, payload, scales, chunk,
                                              nccl_rank),
        **ops.TOLERANCE["weighted_agg_quant_sharded"][torch.int8])
    assert torch.equal(got, ops.weighted_agg_quant(c, payload, scales,
                                                   chunk=chunk))


def test_sharded_all_reduce_refuses_a_cuda_tensor_on_gloo(card, tmp_path):
    import torch.distributed as dist
    from repro_torch.fed import make_fed_sharding
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="NCCL"):
            make_fed_sharding().all_reduce(torch.ones(3, device=card))
    finally:
        dist.destroy_process_group()


def test_device_draw_on_the_card_equals_the_cpu(card):
    """core.prng and device_sample_round run the same integer passes, one
    f32 multiply and a truncation on both devices: a span's draws on the
    card equal the CPU's bit for bit, at the EMNIST main path's shape."""
    from repro_torch.core import prng
    from repro_torch.fed.engine import device_sample_round
    C, E, B = 62, 5, 10
    gen = torch.Generator().manual_seed(0)
    n = torch.randint(1, 400, (C,), generator=gen, dtype=torch.int32)
    cdf = torch.sort(torch.rand(C, E + 1, generator=gen), dim=1).values
    cdf[:, -1] = 1.0
    active = (torch.rand(C, generator=gen) < 0.9).float()
    keys = prng.fold_in(prng.prng_key(0), torch.arange(10))
    want = device_sample_round(keys, active, n, cdf, E, B)
    got = device_sample_round(keys.to(card), active.to(card), n.to(card),
                              cdf.to(card), E, B)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    assert torch.equal(prng.uniform(keys.to(card), (C, E, B)).cpu(),
                       prng.uniform(keys, (C, E, B)))


@pytest.mark.parametrize("mode", ["device", "plan"])
def test_checkpoint_saved_and_restored_on_the_card(card, mode, tmp_path):
    """The reference's resume scenario (logreg, 6 clients, every event
    kind, an Arrival with a brand-new client and a Departure pending at
    the cut) run on the card, saved at tau 6 and restored onto the card
    (device=None) into a fresh engine: the resumed rounds launch the
    round's kernels, and the round records equal one uncut run's, params
    within rtol 1e-5, atol 1e-6."""
    import numpy as np
    from repro_torch.benchmarks.reference import reference_init
    from repro_torch.configs.paper import SYNTHETIC_LR as cfg
    from repro_torch.core.participation import TRACES
    from repro_torch.data import synthetic_federation
    from repro_torch.fed import (Arrival, Client, Departure,
                                 InactivityBurst, RoundEngine,
                                 StreamScheduler, TraceShift)
    from repro_torch.models.small import make_loss_fn

    def clients(n, seed):
        train, _ = synthetic_federation(0.5, 0.5, n, seed=seed)
        rng = np.random.default_rng(seed)
        return [Client(x=tr[0], y=tr[1], trace=TRACES[rng.integers(0, 8)])
                for tr in train]

    def scheduler():
        founding = clients(6, 0)
        engine = RoundEngine(loss_fn=make_loss_fn(cfg), clients=founding,
                             local_epochs=5, batch_size=6, eta0=1.0,
                             capacity=8, max_samples=600,
                             model_kind=cfg.kind)
        return StreamScheduler(
            clients=founding, init_params=reference_init(cfg, card),
            engine=engine, mode=mode, seed=0,
            events=[TraceShift(2, client_id=0, trace=TRACES[1]),
                    InactivityBurst(3, 2, (1, 2)),
                    Departure(5, client_id=3, policy="exclude"),
                    Arrival(8, client=clients(1, 500)[0]),
                    Departure(10, client_id=1, policy="include")])

    uncut = scheduler()
    uncut.run(12, eval_every=4)
    cut = scheduler()
    cut.run(6, eval_every=4)
    cut.save(str(tmp_path / "ckpt"))
    del cut
    res = StreamScheduler.restore(str(tmp_path / "ckpt"),
                                  loss_fn=make_loss_fn(cfg))
    assert res.engine.device.type == "cuda" and res.pending == 2
    ops.reset_launches()
    res.run(6, eval_every=4)
    torch.cuda.synchronize()
    assert ops.launches["weighted_agg"] == 6
    assert ops.launches["masked_sgd"] == 6 * 2 * 5
    for a, b in zip(res.history, uncut.history, strict=True):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        assert np.array_equal(a.s, b.s)
    for k, v in uncut.params.items():
        torch.testing.assert_close(res.params[k], v, rtol=1e-5, atol=1e-6)


def test_stager_stages_on_its_own_stream_from_pinned_memory(card):
    """On the card the CohortStager copies a cohort from pinned host stacks
    on a stream of its own, and the staging thread waits for the copies:
    the collected stacks are the padded rows, on the card, allocated from
    that stream's pool."""
    import numpy as np
    from repro_torch.configs.paper import SYNTHETIC_LR as cfg
    from repro_torch.core.participation import TRACES
    from repro_torch.data import synthetic_federation
    from repro_torch.fed import Client, RoundEngine
    from repro_torch.fed.bank import CohortStager, pad_rows
    from repro_torch.models.small import make_loss_fn

    train, _ = synthetic_federation(0.5, 0.5, 5, seed=3)
    clients = [Client(x=tr[0], y=tr[1], trace=TRACES[0]) for tr in train]
    engine = RoundEngine(loss_fn=make_loss_fn(cfg), clients=clients[:2],
                         local_epochs=5, batch_size=6, capacity=4,
                         max_samples=600, model_kind=cfg.kind)
    stager = CohortStager(engine)
    assert stager._stream is not None
    assert stager._stream != torch.cuda.current_stream(card)
    stager.submit([(None, c) for c in clients[2:]])
    cohort = stager.collect()
    stager.close()
    assert stager.stats()["stage_errors"] == 0 and cohort.k == 3
    for name, dev in cohort.dev.items():
        assert dev.is_cuda and dev.shape[0] == 4
        for j, c in enumerate(clients[2:] + clients[-1:]):
            want = pad_rows(engine.task, engine.nmax, c)[name]
            assert np.array_equal(dev[j].cpu().numpy(), want)


@pytest.mark.parametrize("mode", ["device", "plan"])
def test_prefetching_scheduler_on_the_card_is_the_resident_one(card, mode):
    """A flash crowd on the card with prefetch on (the commit reading the
    staging stream's stacks on the scheduler's stream) against the same
    run without a bank: every arrival a hit, no staging error, records and
    params bit-identical."""
    from repro_torch.fed.scenarios import build_scheduler, make_scenario
    runs = []
    for prefetch in (False, True):
        sch = build_scheduler(make_scenario("flash-crowd", n_rounds=12),
                              mode=mode, prefetch=prefetch)
        sch.run(12, eval_every=4)
        torch.cuda.synchronize()
        sch.close()
        runs.append(sch)
    plain, banked = runs
    stats = banked.prefetch_stats()
    assert stats["hits"] == 6 and stats["misses"] == 0
    assert stats["stager"]["stage_errors"] == 0
    for a, b in zip(banked.history, plain.history, strict=True):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        assert (a.s == b.s).all()
    for k, v in plain.params.items():
        assert torch.equal(banked.params[k], v), k


def _flash_crowd_service_runs(plan=None, tmp_path=None, **sched):
    """flash-crowd (12 rounds, prefetch) on the card through a
    FederationService, its events submitted before the worker starts
    (spans of 2 rounds, supervised with the engine reused when ``plan`` is
    given), beside the same schedule preloaded into a blocking
    scheduler: (service, blocking scheduler)."""
    from repro_torch.configs.paper import SYNTHETIC_LR as cfg
    from repro_torch.fed import FederationService
    from repro_torch.fed.scenarios import (_paper_eval_fn, build_scheduler,
                                           make_scenario)
    from repro_torch.models.small import make_loss_fn
    sc = make_scenario("flash-crowd", n_rounds=12, arrive_at=4, stay=4)
    blocking = build_scheduler(sc, prefetch=True, **sched)
    blocking.run(12, eval_every=4)
    blocking.close()
    events, sc.events = sc.events, []
    sch = build_scheduler(sc, prefetch=True, **sched)
    kw = {}
    if plan is not None:
        sch.injector = plan
        eng = sch.engine
        kw = dict(supervise=True, snapshot_dir=str(tmp_path),
                  snapshot_every=1, backoff0=0.01, span_timeout=2.0,
                  engine_factory=lambda: eng,
                  restore_kwargs=dict(loss_fn=make_loss_fn(cfg),
                                      eval_fn=_paper_eval_fn()))
    svc = FederationService(sch, span_rounds=2, eval_every=4, max_rounds=12,
                            **kw)
    svc.submit(*events)
    with svc:
        assert svc.wait_rounds(12, timeout=300), svc.stats()
    torch.cuda.synchronize()
    return svc, blocking


def _same_run(got, want):
    for a, b in zip(got.history, want.history, strict=True):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        assert (a.s == b.s).all()
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v), k


def test_service_worker_on_the_card_with_the_staging_stream(card):
    """A worker generation runs its spans on the card while the bank's
    stager stages the crowd on its own stream: every arrival a hit, no
    staging error, the blocking run's records and params bit for bit."""
    svc, blocking = _flash_crowd_service_runs()
    st = svc.stats()
    assert st["events_ingested"] == st["events_applied"] == 12
    assert st["prefetch"]["hits"] == 6 and st["prefetch"]["misses"] == 0
    assert st["prefetch"]["stager"]["stage_errors"] == 0
    _same_run(svc.scheduler, blocking)


def test_recovery_reuses_the_engine_while_a_cohort_stages(card, tmp_path):
    """A worker crash at the boundary where the crowd's cohort is in flight
    on the staging stream, and a mid-span crash after it: the supervisor
    joins the worker, closes its scheduler (the stager retired) and
    restores onto the same engine; the run is the fault-free one bit for
    bit, and the restored stager stages without error."""
    from repro_torch.fed import Fault, FaultPlan
    plan = FaultPlan([Fault("worker", 2, "crash"),
                      Fault("sched_span", 5, "crash")])
    svc, blocking = _flash_crowd_service_runs(plan, tmp_path)
    rep = svc.chaos_report()
    assert rep["n_recoveries"] == 2
    assert all(r["engine_reused"] and "InjectedFault" in r["cause"]
               for r in rep["recoveries"])
    assert svc.scheduler.engine.device == card
    assert svc.scheduler.prefetch_stats()["stager"]["stage_errors"] == 0
    _same_run(svc.scheduler, blocking)


def test_service_worker_enters_the_engines_device(card):
    """Each worker generation's thread runs with the engine's card current
    (a new thread's current device is device 0): here the last card."""
    from repro_torch.fed import FederationService
    from repro_torch.fed.scenarios import build_scheduler, make_scenario
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    sch = build_scheduler(make_scenario("churn", n_rounds=4), device=dev)
    seen = []
    run = sch.run

    def recorded(n_rounds, eval_every=1):
        seen.append(torch.cuda.current_device())
        return run(n_rounds, eval_every=eval_every)
    sch.run = recorded
    with FederationService(sch, span_rounds=2, max_rounds=4) as svc:
        assert svc.wait_rounds(4, timeout=120)
    assert seen == [dev.index, dev.index]


def test_fuzz_case_on_the_card_with_every_invariant(card):
    """One fuzz case on the card with every invariant (exact resume, zero
    rebuilds, weight sanity, plan parity), launching the round's kernels
    (weighted_agg once and masked_sgd 2 leaves x E a round of the
    uninterrupted run), and its records equal to the same case on the CPU
    (s bit for bit: one draw, one s-law table)."""
    from repro_torch.fed import FuzzHarness, generate_case, run_fuzz_case
    from repro_torch.fed.fuzz import _execute, _fn_signature
    seed = 0                # two kills, 19 rounds
    on_card = FuzzHarness(device=card)
    assert {"weighted_agg", "weighted_agg_quant", "masked_sgd"} <= \
        set(_fn_signature(on_card.engine)["kernels"])
    stats = run_fuzz_case(on_card, seed)
    assert stats["plan_parity"] and stats["resumes"] == stats["kills"] > 0
    case = generate_case(seed)
    ops.reset_launches()
    card_run = _execute(on_card, case, mode="device", honor_kills=False)
    torch.cuda.synchronize()
    R = case.total_rounds
    assert ops.launches["weighted_agg"] == R
    assert ops.launches["masked_sgd"] == 2 * on_card.E * R
    cpu_run = _execute(FuzzHarness(device="cpu"), case, mode="device",
                       honor_kills=False)
    assert len(card_run["history"]) == len(cpu_run["history"]) == R
    for a, b in zip(card_run["history"], cpu_run["history"]):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        assert (a.s == b.s).all()
    assert card_run["state"].slot_of == cpu_run["state"].slot_of
