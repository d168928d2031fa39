"""The port's wire format (``repro_torch.core.compression``) against the
reference's (``repro.core.compression``), on the same numpy inputs.

The quantizer is held bit for bit: payload codes equal and scales equal to
the last bit (compared as int32 words), across the reference suite's
property grid of magnitudes and its subnormal, flushed-subnormal, all-zero
and single-outlier chunks (tests/test_compression.py:67-110), other
``levels``, and the top-k mask with ties.  round_trip, dequantize_chunked
and wire_bytes are held equal too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as R
from repro_torch.core import compression as P
from repro_torch.kernels.weighted_agg import VECTOR_BYTES


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPEC_NAMES = ("none", "bf16", "int8", "int8-topk",
              "int8:chunk=1024,levels=63", "int8-topk:topk=0.05",
              "int8:levels=1,chunk=4096", "int8:chunk=100")


def _bits(a) -> np.ndarray:
    """f32 values as their int32 words: equal words, equal bits."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _assert_same_wire(x: np.ndarray, spec_name: str) -> None:
    """compress_flat of both packages on x: equal codes, equal scale bits;
    the port's payload rows start on 16 bytes."""
    ref_spec = R.resolve_compression(spec_name)
    want_p, want_s = R.compress_flat(jnp.asarray(x), ref_spec)
    got_p, got_s = P.compress_flat(torch.from_numpy(x),
                                   P.resolve_compression(spec_name))
    assert got_p.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(want_s))
    assert got_p.stride(0) % VECTOR_BYTES == 0


# -- spec parsing --------------------------------------------------------------

def dataclass_fields(spec):
    return (spec.kind, spec.chunk, spec.levels, spec.topk_frac)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_spec_and_name_match_reference(name):
    ref, port = R.resolve_compression(name), P.resolve_compression(name)
    assert dataclass_fields(port) == dataclass_fields(ref)
    assert (port.name, port.quantized, port.active) == \
        (ref.name, ref.quantized, ref.active)
    assert P.resolve_compression(port.name) == port


def test_resolve_passes_specs_and_none_through():
    assert P.resolve_compression(None) == P.CompressionSpec("none")
    spec = P.CompressionSpec(kind="int8", chunk=512)
    assert P.resolve_compression(spec) is spec
    with pytest.raises(TypeError):
        P.resolve_compression(8)


@pytest.mark.parametrize("bad", [
    dict(spec="int4", match="kind"),
    dict(spec="int8:chunk=0"), dict(spec="int8:levels=0"),
    dict(spec="int8:levels=200"), dict(spec="int8-topk:topk=0.0"),
    dict(spec="int8:bogus=1", match="unknown compression option")])
def test_validation_errors_match_reference(bad):
    """Both packages refuse the same specs with ValueError."""
    for pkg in (R, P):
        with pytest.raises(ValueError, match=bad.get("match")):
            pkg.resolve_compression(bad["spec"])


# -- the quantization lattice, bit for bit -------------------------------------

# the reference suite's property grid (K, D, chunk, 2^scale_pow),
# walked deterministically
GRID = [(K, D, chunk, pow_)
        for K, D in [(1, 1), (2, 33), (3, 256), (5, 700), (4, 517)]
        for chunk in (32, 128, 256)
        for pow_ in (-42, -20, 0, 18)]


@pytest.mark.parametrize("K,D,chunk,scale_pow", GRID)
def test_quantize_chunked_is_bit_identical(K, D, chunk, scale_pow):
    rng = np.random.default_rng(K * 100_000 + D * 13 + scale_pow + 50)
    x = (rng.normal(size=(K, D)) * float(2.0 ** scale_pow)).astype(
        np.float32)
    for kind in ("int8", "int8-topk"):
        _assert_same_wire(x, f"{kind}:chunk={chunk}")


def _chunks(kind: str) -> np.ndarray:
    if kind == "subnormal-scale":
        # absmax normal, absmax/levels subnormal: the 2^-126 scale floor
        return np.full((1, 128), 2e-38, np.float32)
    if kind == "flushed-subnormal":
        # subnormal inputs: read as zero, scale 0 and codes 0
        return np.full((1, 128), 1e-40, np.float32)
    if kind == "mixed-subnormal":
        x = np.zeros((1, 64), np.float32)
        x[0, 0], x[0, 1] = 127 * 2.0 ** -126, 0.75 * 2.0 ** -126
        return x
    if kind == "all-zero":
        x = np.zeros((2, 256), np.float32)
        x[1, 128:] = 1.0
        return x
    if kind == "single-outlier":
        x = np.full((1, 256), 1e-6, np.float32)
        x[0, 7] = 1e6
        return x
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["subnormal-scale", "flushed-subnormal",
                                  "mixed-subnormal", "all-zero",
                                  "single-outlier"])
@pytest.mark.parametrize("chunk", [64, 128])
def test_edge_chunks_are_bit_identical(kind, chunk):
    x = _chunks(kind)
    _assert_same_wire(x, f"int8:chunk={chunk}")
    payload, scales = P.quantize_chunked(torch.from_numpy(x), chunk=chunk)
    back = P.dequantize_chunked(payload, scales, chunk=chunk, d=x.shape[1])
    assert torch.isfinite(back).all()
    if kind == "flushed-subnormal":
        assert scales.abs().max() == 0 and payload.abs().max() == 0


@pytest.mark.parametrize("levels", [1, 7, 15, 127])
def test_levels_are_bit_identical(levels):
    x = np.random.default_rng(levels).normal(size=(3, 1000)).astype(
        np.float32)
    _assert_same_wire(x, f"int8:chunk=100,levels={levels}")
    payload, _ = P.quantize_chunked(torch.from_numpy(x), chunk=100,
                                    levels=levels)
    assert int(payload.abs().max()) <= levels


def test_topk_mask_with_ties_matches_reference():
    # per row: magnitudes 1..100 with the 10th largest repeated, so ties at
    # the threshold all survive; one row all equal
    base = np.arange(1, 101, dtype=np.float32)
    x = np.stack([base, -base, np.where(base >= 88, 91.0, base),
                  np.full(100, 3.0, np.float32)]).astype(np.float32)
    got = P.topk_mask(torch.from_numpy(x), 0.1).numpy()
    want = np.asarray(R.topk_mask(jnp.asarray(x), 0.1))
    np.testing.assert_array_equal(got, want)
    assert got[0].sum() == 10 and got[2].sum() == 13 and got[3].all()
    _assert_same_wire(x, "int8-topk:chunk=32")


@pytest.mark.parametrize("name", ["none", "bf16", "int8", "int8-topk",
                                  "int8:chunk=100,levels=7"])
def test_round_trip_matches_reference(name):
    x = np.random.default_rng(1).normal(size=(2, 300)).astype(np.float32)
    got = P.round_trip(torch.from_numpy(x), P.resolve_compression(name))
    want = R.round_trip(jnp.asarray(x), R.resolve_compression(name))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_dequantize_chunked_matches_reference():
    x = np.random.default_rng(2).normal(size=(3, 700)).astype(np.float32)
    wp, ws = R.quantize_chunked(jnp.asarray(x), chunk=128)
    tp, ts = torch.tensor(np.asarray(wp)), torch.tensor(np.asarray(ws))
    got = P.dequantize_chunked(tp, ts, chunk=128)
    want = R.dequantize_chunked(wp, ws, chunk=128)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    got = P.dequantize_chunked(tp, ts, chunk=128, d=700)
    assert got.shape == (3, 700)


def test_compress_flat_refuses_bf16():
    with pytest.raises(ValueError):
        P.compress_flat(torch.zeros(2, 4), P.resolve_compression("bf16"))


@pytest.mark.parametrize("D", [610, 461_630, 1_000_000])
@pytest.mark.parametrize("name", ["none", "bf16", "int8", "int8-topk",
                                  "int8:chunk=100", "int8-topk:topk=0.05"])
def test_wire_bytes_match_reference(D, name):
    for n in (1, 62):
        assert P.wire_bytes(D, name, n_clients=n) == \
            R.wire_bytes(D, name, n_clients=n)
