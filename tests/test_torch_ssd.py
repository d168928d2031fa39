"""The port's Mamba2 SSD serving path (``repro_torch.models.ssd``, the SSM
block, cache and params, ``launch/serve``) against the reference at
``get_config("mamba2-130m").reduced()``, on the same numpy inputs and,
through ``repro_torch.params.lm_from_jax``, the reference's own weights.

Tolerances are the reference suite's own: ``ssd_intra_chunk`` f32 1e-5 and
bf16 rtol 6e-2 / atol 0.4 (``tests/test_kernels.py:222-228``), the
kernel's view of the chunked scan 2e-3 (``:252``), the chunked scan 1e-3
(``tests/test_ssd.py:42-45``), the serving path 1e-4
(``tests/test_decode.py:32-41``); the building blocks are f32 values in
another summation order (1e-5)."""
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.models import blocks as jblocks
from repro.models import ssd as jssd
from repro.models import transformer as jtransformer
from repro.models.params import init_params as jinit_params
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk_plain
from repro_torch.launch import serve as serve_mod
from repro_torch.models import ssd, transformer
from repro_torch.models.blocks import block_apply
from repro_torch.models.params import init_params, param_count
from repro_torch.params import lm_from_jax, lm_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "mamba2-130m"
KEY = jax.random.PRNGKey(0)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=1e-3, atol=1e-3)
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


def _np_params(jcfg, key=KEY):
    return jax.tree.map(np.asarray, jinit_params(key, jcfg))


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **tol)


# -- the kernel's plain version against the Pallas kernel ----------------------

@pytest.mark.parametrize("Q,N,P", [(16, 8, 8), (64, 32, 16), (128, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_chunk_matches_pallas_and_oracle(Q, N, P, dtype):
    """The reference suite's inputs (tests/test_kernels.py:207-217), through
    ``ops.ssd_intra_chunk`` on CPU tensors (its plain version) and the
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(Q + N)
    G = 6
    cum = np.cumsum(-rng.uniform(0.01, 0.1, (G, Q)), axis=-1).astype(
        np.float32)
    jdt = jnp.dtype(dtype)
    C, B = (jnp.asarray(rng.normal(size=(G, Q, N)), jdt) for _ in range(2))
    x = jnp.asarray(rng.normal(size=(G, Q, P)), jdt)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    # bf16 values carried across exactly through f32
    port_in = [_t(np.asarray(a.astype(jnp.float32))).to(tdt)
               for a in (C, B, x)]
    before = dict(ops.launches)
    got = ops.ssd_intra_chunk(_t(cum), *port_in)
    assert ops.launches == before      # a CPU tensor launches no kernel
    assert got.dtype == torch.float32 and got.shape == (G, Q, P)
    tol = ops.TOLERANCE["ssd_intra_chunk"][tdt]
    pallas = ref_ops.ssd_intra_chunk(jnp.asarray(cum), C, B, x,
                                     interpret=True)
    oracle = ref_oracles.ssd_intra_chunk_ref(jnp.asarray(cum), C, B, x)
    _close(got, pallas, **tol)
    # the plain version is the oracle's arithmetic: f32 noise only
    _close(got, oracle, **ops.TOLERANCE["ssd_intra_chunk"][torch.float32])


def test_ssd_intra_chunk_takes_cells_split_and_group_shared_rows():
    """(Go, Gi) cells with C and B expanded over Gi (stride 0) give the
    same as the (G, ...) cells of the copies."""
    rng = np.random.default_rng(1)
    Go, Gi, Q, N, P = 3, 4, 32, 16, 8
    cum = _t(np.cumsum(-rng.uniform(0.01, 0.1, (Go, Gi, Q)), -1)
             .astype(np.float32))
    C, B = (_t(rng.normal(size=(Go, 1, Q, N)).astype(np.float32))
            .expand(Go, Gi, Q, N) for _ in range(2))
    x = _t(rng.normal(size=(Go, Q, Gi, P)).astype(np.float32)).transpose(1, 2)
    got = ops.ssd_intra_chunk(cum, C, B, x)
    assert got.shape == (Go, Gi, Q, P)
    flat = ops.ssd_intra_chunk(cum.reshape(-1, Q), C.reshape(-1, Q, N),
                               B.reshape(-1, Q, N), x.reshape(-1, Q, P))
    torch.testing.assert_close(got.reshape(-1, Q, P), flat, rtol=0, atol=0)


def test_ssd_intra_chunk_refuses_what_the_kernel_does_not_take():
    cum, x = torch.zeros(2, 16), torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="P at most 16"):
        ops.ssd_intra_chunk(cum, x, x, torch.zeros(2, 16, 48))
    with pytest.raises(ValueError, match="N in"):
        ops.ssd_intra_chunk(cum, torch.zeros(2, 16, 300),
                            torch.zeros(2, 16, 300), x)
    with pytest.raises(ValueError, match="takes cum"):
        ops.ssd_intra_chunk(cum, x, x[:, :8], x)
    with pytest.raises(TypeError):
        ops.ssd_intra_chunk(cum, x, x, x.double())
    with pytest.raises(TypeError):
        ops.ssd_intra_chunk(cum.double(), x, x, x)


def test_upper_triangle_overflow_gives_no_nan():
    """At mamba2's decay rates cum_i - cum_j above the diagonal overflows
    exp to inf; the decay is taken only where j <= i, so no inf * 0."""
    rng = np.random.default_rng(2)
    G, Q = 4, 256
    # the upper part of mamba2's dt range and of its decay rates
    dA = -np.exp(rng.uniform(np.log(1e-2), np.log(1e-1), (G, Q))) \
        * rng.uniform(8.0, 16.0, (G, 1))
    cum = _t(np.cumsum(dA, -1).astype(np.float32))
    # cum_i - cum_j at i = 0, j = Q - 1: exp overflows f32 past 88.72
    assert float((cum[:, 0] - cum[:, -1]).min()) > 88.8
    C, B = (_t(rng.normal(size=(G, Q, 16)).astype(np.float32))
            for _ in range(2))
    x = _t(rng.normal(size=(G, Q, 8)).astype(np.float32))
    got = ops.ssd_intra_chunk(cum, C, B, x)
    assert bool(torch.isfinite(got).all())
    want = ref_oracles.ssd_intra_chunk_ref(*(jnp.asarray(t.numpy())
                                             for t in (cum, C, B, x)))
    _close(got, want, **ops.TOLERANCE["ssd_intra_chunk"][torch.float32])


# -- the f32 kernel's arithmetic, emulated in plain PyTorch ---------------------

def _serving_draw(seed, G, H, Q, N, P):
    """Inputs as chip_smoke.ssd_inputs draws them, from numpy: dt
    log-uniform in [1e-3, 1e-1] per position and A in [-16, -1] per cell,
    so that above the diagonal cum_i - cum_j overflows exp in many cells;
    the model's layout, cells (G, H) with C and B of each outer cell shared
    by its H heads through a stride-0 dim; C, B and xdt normal."""
    rng = np.random.default_rng(seed)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (G, H, Q)))
    A = -rng.uniform(1.0, 16.0, (G, H, 1))
    cum = _t(np.cumsum(dt * A, -1).astype(np.float32))
    C, B = (_t(rng.normal(size=(G, 1, Q, N)).astype(np.float32))
            .expand(G, H, Q, N) for _ in range(2))
    xdt = _t(rng.normal(size=(G, Q, H, P)).astype(np.float32)).transpose(1, 2)
    return cum, C, B, xdt


def _decay(cum):
    """L[i, j] = exp(cum_i - cum_j) where j <= i, else 0, the exponent taken
    only where j <= i (exp(0) elsewhere, never the overflowing one)."""
    Q = cum.shape[-1]
    keep = torch.ones(Q, Q, dtype=torch.bool).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    return torch.where(keep, torch.exp(torch.where(keep, diff, 0.0)), 0.0)


def _group_shared(cum, C, B, xdt, product=torch.matmul):
    """The f32 kernel's arithmetic where a CTA takes a group's heads: the
    scores C_g B_g^T once per outer cell (C and B read at head 0 of the
    stride-0 dim), each head's decay applied pair by pair, then each head's
    product with its own xdt."""
    s = product(C[:, 0], B[:, 0].mT)[:, None] * _decay(cum)
    return product(s, xdt)


def _tf32_rna(x):
    """cvt.rna.tf32.f32 on the int32 view: round to 10 explicit mantissa
    bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32x3(a, b):
    """a @ b as the split-precision TF32 design would take it: a = hi + lo,
    hi = rna(a), lo = rna(a - hi), the same for b, and hi hi + hi lo + lo hi
    summed in f32 (each TF32 product exact in f32)."""
    ah = _tf32_rna(a)
    al = _tf32_rna(a - ah)
    bh = _tf32_rna(b)
    bl = _tf32_rna(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _f64(cum, C, B, xdt):
    """The function in f64 (the plain version computes in f32)."""
    s = torch.einsum("...qn,...sn->...qs", C.double(), B.double())
    return (s * _decay(cum.double())) @ xdt.double()


def _tol_ratio(got, want):
    """max |got - want| / (atol + rtol |want|) at ops.TOLERANCE f32: at most
    1 where ``torch.testing.assert_close`` passes."""
    tol = ops.TOLERANCE["ssd_intra_chunk"][torch.float32]
    return ((got.double() - want.double()).abs()
            / (tol["atol"] + tol["rtol"] * want.double().abs())).max().item()


def test_group_shared_arithmetic_matches_plain_and_pallas():
    """The kernel's f32 arithmetic at the serving widths (Q 256, N 128, P
    64), the inputs drawn as on the card with the upper triangle
    overflowing exp, small G: finite, and within ops.TOLERANCE of the plain
    version and of the reference's Pallas kernel in interpret mode (cells
    flattened, C and B copied per head)."""
    G, H, Q, N, P = 4, 24, 256, 128, 64
    cum, C, B, xdt = _serving_draw(20, G, H, Q, N, P)
    assert float((cum[..., 0] - cum[..., -1]).max()) > 88.8   # exp overflows
    got = _group_shared(cum, C, B, xdt)
    assert bool(torch.isfinite(got).all())
    want = ssd_intra_chunk_plain(cum, C, B, xdt)
    tol = ops.TOLERANCE["ssd_intra_chunk"][torch.float32]
    torch.testing.assert_close(got, want, **tol)
    flat = [jnp.asarray(t.reshape(G * H, Q, -1).squeeze(-1).numpy())
            for t in (cum[..., None], C, B, xdt)]
    pallas = ref_ops.ssd_intra_chunk(*flat, interpret=True)
    _close(got.reshape(G * H, Q, P), pallas, **tol)


@pytest.mark.parametrize("case", ["reference Q=128", "serving widths"])
def test_tf32x3_is_f32_accurate_but_leaves_the_tolerance(case, capsys):
    """The rehearsal of a tensor-core design: both products as three TF32
    products each (3xTF32).  Against the f64 answer it is within 2x the
    plain f32 version's own error: as accurate as f32.  But its roundings
    fall elsewhere than the plain version's, and so do the f64 answer's: at
    the serving widths both lie outside ops.TOLERANCE (rtol = atol = 1e-5)
    of the plain version, and of the reference's Pallas kernel at the
    reference suite's Q = 128.  So the kernel keeps the plain version's f32
    sums in their order (run with -s for the ratios)."""
    if case == "serving widths":
        G, H, Q, N, P = 2, 24, 256, 128, 64
        cum, C, B, xdt = _serving_draw(21, G, H, Q, N, P)
        C, B, xdt = C.contiguous(), B.contiguous(), xdt.contiguous()
    else:   # tests/test_kernels.py:207-217's draw
        rng = np.random.default_rng(128 + 64)
        G, H, Q, N, P = 6, 1, 128, 64, 64
        cum = _t(np.cumsum(-rng.uniform(0.01, 0.1, (G, H, Q)), -1)
                 .astype(np.float32))
        C, B = (_t(rng.normal(size=(G, H, Q, N)).astype(np.float32))
                for _ in range(2))
        xdt = _t(rng.normal(size=(G, H, Q, P)).astype(np.float32))
    emu = _group_shared(cum, C, B, xdt, product=_tf32x3)
    plain = ssd_intra_chunk_plain(cum, C, B, xdt)
    exact = _f64(cum, C, B, xdt)
    err_emu = (emu.double() - exact).abs().max().item()
    err_plain = (plain.double() - exact).abs().max().item()
    flat = [jnp.asarray(t.reshape(G * H, Q, -1).squeeze(-1).numpy())
            for t in (cum[..., None], C, B, xdt)]
    pallas = torch.tensor(np.asarray(
        ref_ops.ssd_intra_chunk(*flat, interpret=True))).reshape(G, H, Q, P)
    ratios = {name: _tol_ratio(emu, ref) for name, ref in
              (("plain", plain), ("pallas", pallas))}
    with capsys.disabled():
        print(f"\n3xTF32 at {case}: max |y - y64| {err_emu:.3e} (plain f32 "
              f"{err_plain:.3e}); max |y - ref| / tol against the plain "
              f"version {ratios['plain']:.2f}, the Pallas kernel "
              f"{ratios['pallas']:.2f}; the f64 answer against the plain "
              f"version {_tol_ratio(exact, plain):.2f}")
    assert bool(torch.isfinite(emu).all())
    assert err_emu <= 2 * err_plain
    assert ratios["plain"] > 1 and ratios["pallas"] > 1
    if case == "serving widths":
        assert _tol_ratio(exact, plain) > 1


def test_wrapper_takes_group_shared_scores_only_through_stride_0_heads():
    """The f32 kernel's path, chosen in Python: several heads per CTA where
    C's and B's head strides are both 0 (the model's layout), one head per
    CTA for flat cells and for C or B shared alone."""
    from repro_torch.kernels import ssd_chunk as sc
    Go, H, Q, N = 3, 24, 256, 16
    rows = torch.zeros(Go, 1, Q, N)
    shared = rows.expand(Go, H, Q, N)
    own = torch.zeros(Go, H, Q, N)
    assert sc.group_shared(shared, shared)
    assert not sc.group_shared(shared, own)
    assert not sc.group_shared(own, shared)
    assert not sc.group_shared(own, own)
    assert not sc.group_shared(torch.zeros(Go, Q, N), torch.zeros(Go, Q, N))
    assert not sc.group_shared(rows, rows)              # one head: no group
    # the serving prefill's cells fill 132 SMs with whole groups: 24 heads
    # per CTA, the group's scores computed once per (cell, query tile); the
    # kernel's 3 consumer warpgroups (2 at P = 128) take a CTA's heads in
    # turn, a count the library gives (ssd_intra_chunk_f32_warpgroups)
    n_wg = 3
    assert sc.heads_per_cta(64, 24, 256, True, 132, n_wg) == 24
    # too few cells for the card: the heads cut into blocks of whole
    # rounds of the warpgroups, each CTA still computing its group's
    # scores once for its block
    assert sc.heads_per_cta(1, 24, 256, True, 132, n_wg) == 3
    assert sc.heads_per_cta(8, 24, 256, True, 132, n_wg) == 6
    assert sc.heads_per_cta(1, 24, 256, True, 132, 2) == 2
    assert sc.heads_per_cta(6, 5, 100, True, 132, n_wg) == 3
    assert sc.heads_per_cta(64, 24, 256, False, 132, n_wg) == 1
    assert sc.heads_per_cta(6, 1, 256, False, 132, n_wg) == 1
    # the f32 entry takes the heads per CTA, the bf16 entry does not
    f32, bf16 = (sc.SIGNATURES[f"ssd_intra_chunk_{t}"] for t in ("f32",
                                                                 "bf16"))
    assert len(f32) == len(bf16) + 1
    assert sc.SIGNATURES["ssd_intra_chunk_f32_warpgroups"] == (ctypes.c_int,)


def _f32_excess(got, cum, C, B, xdt):
    """max |got - y64| over the f32 rounding bound of any summation order
    (chip_smoke.SSD_F32_BOUND): 2^-24 sum_j (sum_n |C_in| |B_jn|) L_ij
    (N + Q + 8 + |cum_i - cum_j|) |xdt_j|; at most 1 for f32 arithmetic."""
    Q, N = cum.shape[-1], C.shape[-1]
    cum = cum.double()
    L = _decay(cum)
    Cd, Bd, xd = C.double(), B.double(), xdt.double()
    y64 = (torch.einsum("...qn,...sn->...qs", Cd, Bd) * L) @ xd
    W = L * (N + Q + 8 + (cum[..., :, None] - cum[..., None, :]).abs())
    bound = 2.0 ** -24 * ((torch.einsum("...qn,...sn->...qs", Cd.abs(),
                                        Bd.abs()) * W) @ xd.abs())
    return ((got.double() - y64).abs() / bound.clamp_min(1e-300)).max() \
        .item()


@pytest.mark.parametrize("arithmetic", ["plain", "group-shared", "pallas",
                                        "3xTF32"])
def test_f32_arithmetics_lie_within_the_f32_bound_of_f64(arithmetic, capsys):
    """ops.TOLERANCE holds the f32 kernel to its plain version's summation
    order at the serving widths (test_tf32x3_is_f32_accurate_but_leaves_the_
    tolerance); the check beside it holds any f32 order to the function in
    f64 within the rounding bound of _f32_excess.  The plain version, the
    kernel's group-shared arithmetic, the reference's Pallas kernel in
    interpret mode and the 3xTF32 split (whose dropped lo * lo term is
    below 2^-22 of each product) all lie within it, on the inputs drawn as
    on the card, the upper triangle overflowing exp; a result that skips
    the first key tile does not."""
    G, H, Q, N, P = 2, 24, 256, 128, 64
    cum, C, B, xdt = _serving_draw(22, G, H, Q, N, P)
    if arithmetic == "plain":
        got = ssd_intra_chunk_plain(cum, C, B, xdt)
    elif arithmetic == "group-shared":
        got = _group_shared(cum, C, B, xdt)
    elif arithmetic == "3xTF32":
        got = _group_shared(cum, C.contiguous(), B.contiguous(),
                            xdt.contiguous(), product=_tf32x3)
    else:
        flat = [jnp.asarray(t.reshape(G * H, Q, -1).squeeze(-1).numpy())
                for t in (cum[..., None], C, B, xdt)]
        got = torch.tensor(np.asarray(ref_ops.ssd_intra_chunk(
            *flat, interpret=True))).reshape(G, H, Q, P)
    assert bool(torch.isfinite(got).all())
    excess = _f32_excess(got, cum, C, B, xdt)
    # the first key tile skipped where a query tile reads more than one
    s = (C[:, 0] @ B[:, 0].mT)[:, None] * _decay(cum)
    s[..., 64:, :64] = 0.0
    assert _f32_excess(s @ xdt, cum, C, B, xdt) > 1.0
    with capsys.disabled():
        print(f"\n{arithmetic}: max |y - y64| / f32 bound {excess:.4f}")
    assert excess <= 1.0


def test_kernel_view_reproduces_the_chunked_scan():
    """tests/test_kernels.py:231-253 on the port: single chunk, zero
    initial state, so the whole output is the intra-chunk term."""
    rng = np.random.default_rng(0)
    Bb, S, H, P, N = 1, 32, 2, 8, 4   # one chunk of Q=S, G=H groups
    x = rng.normal(size=(Bb, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (Bb, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm = rng.normal(size=(Bb, S, H, N)).astype(np.float32)
    Cm = rng.normal(size=(Bb, S, H, N)).astype(np.float32)
    y_model, _ = ssd.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm),
                                 chunk=S)
    cum = torch.cumsum(_t(dt) * _t(A)[None, None, :], dim=1)
    cum_g = cum.movedim(-1, 1).reshape(Bb * H, S)
    C_g = _t(Cm).movedim(2, 1).reshape(Bb * H, S, N)
    B_g = _t(Bm).movedim(2, 1).reshape(Bb * H, S, N)
    x_g = (_t(x) * _t(dt)[..., None]).movedim(2, 1).reshape(Bb * H, S, P)
    y_k = ops.ssd_intra_chunk(cum_g, C_g, B_g, x_g)
    y_k = y_k.reshape(Bb, H, S, P).movedim(1, 2)
    torch.testing.assert_close(y_k, y_model, rtol=2e-3, atol=2e-3)
    y_ref, _ = jssd.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                                chunk=S)
    _close(y_model, y_ref, **SCAN_TOL)


# -- the chunked scan and the recurrence ---------------------------------------

def _scan_inputs(seed, Bb=2, S=16, H=4, P=8, G=2, N=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Bb, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(Bb, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(Bb, S, G, N)).astype(np.float32),
            rng.normal(size=(Bb, S, G, N)).astype(np.float32),
            rng.normal(size=(Bb, G, H // G, P, N)).astype(np.float32))


@pytest.mark.parametrize("S,chunk,with_h0", [
    (16, 4, False), (32, 16, False), (32, 32, True), (24, 16, True),
    (100, 32, False), (7, 4, True), (256, 64, True)])
def test_ssd_chunked_matches_reference(S, chunk, with_h0):
    """Several chunks (the inter-chunk recurrence), Q halved until it
    divides S (24 -> 8, 100 -> 4, 7 -> 1), and a carried initial state."""
    x, dt, A, B, C, h0 = _scan_inputs(S + chunk, S=S)
    h0 = h0 if with_h0 else None
    want, want_h = jssd.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk,
        h0=None if h0 is None else jnp.asarray(h0))
    got, got_h = ssd.ssd_chunked(*(_t(a) for a in (x, dt, A, B, C)), chunk,
                                 h0=None if h0 is None else _t(h0))
    _close(got, want, **SCAN_TOL)
    _close(got_h, want_h, **SCAN_TOL)
    # the intra-chunk term through its plain version directly: the same
    plain, _ = ssd.ssd_chunked(*(_t(a) for a in (x, dt, A, B, C)), chunk,
                               h0=None if h0 is None else _t(h0),
                               intra=ssd_intra_chunk_plain)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_segsum_decode_step_and_causal_conv_match_reference():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(3, 9)).astype(np.float32)
    got, want = ssd.segsum(_t(v)), np.asarray(jssd.segsum(jnp.asarray(v)))
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], **BLOCK_TOL)

    x, dt, A, B, C, h = _scan_inputs(4, S=1)
    want, want_h = jssd.ssd_decode_step(
        jnp.asarray(h), jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]),
        jnp.asarray(A), jnp.asarray(B[:, 0]), jnp.asarray(C[:, 0]))
    got, got_h = ssd.ssd_decode_step(_t(h), _t(x[:, 0]), _t(dt[:, 0]),
                                     _t(A), _t(B[:, 0]), _t(C[:, 0]))
    _close(got, want, **BLOCK_TOL)
    _close(got_h, want_h, **BLOCK_TOL)

    xBC = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    _close(ssd._causal_conv(_t(xBC), _t(w), _t(b)),
           jssd._causal_conv(jnp.asarray(xBC), jnp.asarray(w),
                             jnp.asarray(b)), **BLOCK_TOL)


def test_chunked_scan_matches_step_by_step_decode():
    """The port's own two forms agree: the chunked scan against the
    one-token recurrence (tests/test_ssd.py:26-44's check)."""
    x, dt, A, B, C, _ = _scan_inputs(5, S=32)
    y, h_last = ssd.ssd_chunked(*(_t(a) for a in (x, dt, A, B, C)), 8)
    h = torch.zeros(2, 2, 2, 8, 4)
    for t in range(32):
        y_t, h = ssd.ssd_decode_step(h, _t(x[:, t]), _t(dt[:, t]), _t(A),
                                     _t(B[:, t]), _t(C[:, t]))
        torch.testing.assert_close(y_t, y[:, t], **SCAN_TOL)
    torch.testing.assert_close(h, h_last, **SCAN_TOL)


# -- the mixer and the block ---------------------------------------------------

def _layer0(jcfg):
    return jax.tree.map(lambda a: np.asarray(a[0]), _np_params(jcfg)["blocks"])


def test_mamba_mixer_prefill_and_decode_match_reference():
    jcfg, cfg = _cfgs()
    p = _layer0(jcfg)["ssm"]
    rng = np.random.default_rng(6)
    # non-zero biases and norm scales exercise every term
    p["conv_b"] = (0.1 * rng.normal(size=p["conv_b"].shape)).astype(
        np.float32)
    p["ssm_norm"] = (0.1 * rng.normal(size=p["ssm_norm"].shape)).astype(
        np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    B, S = 2, 40
    u = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    # no cache
    want, _ = jssd.mamba_mixer(p, u, jcfg)
    got, cache = ssd.mamba_mixer(tp, _t(u), cfg)
    _close(got, want, **BLOCK_TOL)
    assert cache is None
    # prefill into a cache, then decode steps
    G, N, K = cfg.ssm_n_groups, cfg.ssm_d_state, cfg.ssm_d_conv
    H = cfg.ssm_n_heads
    conv_ch = cfg.d_inner + 2 * G * N
    jcache = {"conv": jnp.zeros((B, K - 1, conv_ch)),
              "state": jnp.zeros((B, G, H // G, cfg.ssm_head_dim, N))}
    cache = {"conv": torch.zeros(B, K - 1, conv_ch),
             "state": torch.zeros(B, G, H // G, cfg.ssm_head_dim, N)}
    conv, state = cache["conv"], cache["state"]
    want, jcache = jssd.mamba_mixer(p, u, jcfg, cache=jcache)
    got, cache = ssd.mamba_mixer(tp, _t(u), cfg, cache=cache)
    _close(got, want, **BLOCK_TOL)
    assert cache["conv"] is conv and cache["state"] is state   # in place
    for t in range(3):
        u1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jssd.mamba_mixer(p, u1, jcfg, cache=jcache,
                                        decode=True)
        got, cache = ssd.mamba_mixer(tp, _t(u1), cfg, cache=cache,
                                     decode=True)
        _close(got, want, **BLOCK_TOL)
        for name in ("conv", "state"):
            _close(cache[name], jcache[name], **BLOCK_TOL)


def test_ssm_block_matches_reference():
    jcfg, cfg = _cfgs()
    p = _layer0(jcfg)
    x = np.random.default_rng(7).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    want, _, _ = jblocks.block_apply(p, x, jcfg, "ssm", pos)
    got, aux, cache = block_apply(jax.tree.map(_t, p), _t(x), cfg, "ssm",
                                  _t(pos).long())
    _close(got, want, **BLOCK_TOL)
    assert aux == 0.0 and cache is None


# -- params and cache ----------------------------------------------------------

def test_init_params_match_the_reference_tree_and_ssm_init():
    """The reference's tree, shapes and dtypes; ``D`` equal and ``A_log``
    and ``dt_bias`` within one f32 ulp of the reference's.  Both draw them
    from numpy's default_rng(0); the reference takes log and expm1 in XLA's
    f32 approximations, the port in PyTorch's, which round some values
    differently (by at most 1 ulp in the final values)."""
    for jcfg, cfg in (_cfgs(), (jget_config(ARCH), get_config(ARCH))):
        jp = jinit_params(KEY, jcfg) if jcfg.n_layers == 2 else \
            jax.eval_shape(lambda: jinit_params(KEY, jcfg))
        ref_ssm = _np_params(jcfg)["blocks"]["ssm"] \
            if jcfg.n_layers == 2 else None
        mine = init_params(cfg, seed=0, device="cpu")
        assert jax.tree.structure(mine) == jax.tree.structure(jp)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(mine)):
            assert tuple(a.shape) == tuple(b.shape)
            assert np.dtype(a.dtype).name == str(b.dtype).split(".")[-1]
        n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
        assert param_count(mine) == n
        if jcfg.n_layers == 24:                  # full width: 129.1 M
            assert n == 129_100_224
        if ref_ssm is None:
            continue
        ssm_p = mine["blocks"]["ssm"]
        np.testing.assert_array_equal(ssm_p["D"].numpy(), ref_ssm["D"])
        for name in ("A_log", "dt_bias"):
            ulps = np.abs(ssm_p[name].numpy().view(np.int32).astype(np.int64)
                          - ref_ssm[name].view(np.int32))
            assert ulps.max() <= 1, (name, ulps)
            # the same values in every layer, as the reference broadcasts
            assert torch.equal(ssm_p[name], ssm_p[name][:1].expand_as(
                ssm_p[name]))


def test_init_cache_matches_reference():
    jcfg, cfg = _cfgs()
    want = jtransformer.init_cache(jcfg, 3, 17)
    got = transformer.init_cache(cfg, 3, 17, device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(lm_to_numpy(got))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.dtype(a.dtype).name == str(b.dtype).split(".")[-1]
        assert not b.any()
    bf16 = transformer.init_cache(dataclasses.replace(cfg, dtype="bfloat16"),
                                  1, 4, device="cpu")["blocks"]["ssm"]
    assert bf16["conv"].dtype == torch.bfloat16
    assert bf16["state"].dtype == torch.float32


def test_converter_carries_ssm_leaves_exactly():
    """f32 leaves unchanged and bf16 leaves bit for bit."""
    jcfg, _ = _cfgs()
    jparams = _np_params(dataclasses.replace(jcfg, dtype="bfloat16"))
    params = lm_from_jax(jparams, device="cpu")
    ssm_p, jssm = params["blocks"]["ssm"], jparams["blocks"]["ssm"]
    assert ssm_p["in_x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ssm_p["in_x"].view(torch.int16).numpy(),
                                  jssm["in_x"].view(np.int16))
    for name in ("A_log", "D", "dt_bias", "ssm_norm"):
        assert ssm_p[name].dtype == torch.float32
        np.testing.assert_array_equal(ssm_p[name].numpy(), jssm[name])
    back = lm_to_numpy(params)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a.astype(np.float32), b)


# -- the whole slice with the reference's weights ------------------------------

@pytest.mark.parametrize("S", [32, 100])
def test_prefill_and_decode_match_reference(S):
    """Prefill of S - 4 tokens (S = 100: chunks of 32 halved to 32 ... 4
    for 96 tokens), then 4 decode steps, with the reference's weights."""
    jcfg, cfg = _cfgs()
    jparams = _np_params(jcfg)
    params = lm_from_jax(jparams, device="cpu")
    B, Sp = 2, S - 4
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    tt = torch.tensor(tokens).long()
    jcache = jtransformer.init_cache(jcfg, B, S)
    cache = transformer.init_cache(cfg, B, S, device="cpu")
    before = dict(ops.launches)
    want, jcache = jtransformer.prefill(jparams, jcfg, tokens[:, :Sp], jcache)
    got, cache = transformer.prefill(params, cfg, tt[:, :Sp], cache)
    assert got.dtype == torch.float32 and got.shape == (B, 1, cfg.vocab)
    _close(got, want, **SLICE_TOL)
    for t in range(Sp, S):
        want, jcache = jtransformer.decode_step(
            jparams, jcfg, jcache, tokens[:, t:t + 1], jnp.int32(t))
        got, cache = transformer.decode_step(params, cfg, cache,
                                             tt[:, t:t + 1], t)
        _close(got, want, **SLICE_TOL)
    for name in ("conv", "state"):
        _close(cache["blocks"]["ssm"][name], jcache["blocks"]["ssm"][name],
               **SLICE_TOL)
    assert ops.launches == before          # the CPU takes the plain versions


def test_prefill_decode_matches_own_full_forward():
    _, cfg = _cfgs()
    params = init_params(cfg, seed=1, device="cpu")
    B, S = 2, 64
    tokens = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, S))).long()
    h, _, _ = transformer.model_forward(params, cfg, tokens)
    full = transformer.logits_fn(params, cfg, h)[..., :cfg.vocab]
    Sp = S - 4
    cache = transformer.init_cache(cfg, B, S, device="cpu")
    lg, cache = transformer.prefill(params, cfg, tokens[:, :Sp], cache)
    torch.testing.assert_close(lg[:, 0], full[:, Sp - 1], **SLICE_TOL)
    for t in range(Sp, S):
        lg, cache = transformer.decode_step(params, cfg, cache,
                                            tokens[:, t:t + 1], t)
        torch.testing.assert_close(lg[:, 0], full[:, t], **SLICE_TOL)


# -- the serving entry point ---------------------------------------------------

def test_serve_prefill_matches_reference_on_its_prompts():
    jcfg, cfg = _cfgs()
    jparams = _np_params(jcfg)
    out = serve_mod.serve(cfg, batch=2, prompt_len=40, gen=3, seed=0,
                          device="cpu",
                          params=lm_from_jax(jparams, device="cpu"))
    assert out["tokens"].shape == (2, 3)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab)).all())
    assert torch.isfinite(out["logits"]).all()
    prompts = out["prompts"].numpy().astype(np.int32)
    want, _ = jtransformer.prefill(jparams, jcfg, prompts,
                                   jtransformer.init_cache(jcfg, 2, 43))
    _close(out["prefill_logits"], want, **SLICE_TOL)


def test_serve_cli_runs_mamba2_on_the_cpu(capsys):
    serve_mod.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "40", "--gen", "2"])
    out = capsys.readouterr().out
    assert "serving mamba2-130m" in out and "decode: 4 tokens" in out
